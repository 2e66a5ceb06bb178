// Conditional IF nodes in a CUDA graph captured from a stream: the device
// decides whether a stretch of the graph runs, so a loop with an early exit
// (the mini-GN's rounds, the window LM's iterations) is captured as a flat
// sequence of conditional bodies and replays without reading its flag back
// to the host (the reference's `lax.while_loop`).
//
// lio_if_begin, called while `parent` is being captured: creates a
// conditional handle in the parent's graph, captures a one-thread kernel
// that sets it from a device bool (negated with `negate`), adds an IF node
// after it, makes the parent's later work depend on that node, and starts
// capturing `body` into the node's body graph. The caller enqueues the
// body's work on `body`, then calls lio_if_end(body). CUDA >= 12.4.
//
// lio_stamp: a one-thread kernel on `stream` that reads the device's
// nanosecond clock (%globaltimer), takes the next slot of a ring of
// `mask` + 1 entries (a power of two) with atomicAdd on `count`, and writes
// (tag, ns) there. Launched while a stream is captured, it becomes a node
// of the graph, its tag fixed; inside a conditional body it runs only where
// the body runs. `count` keeps counting past the ring's size, so the
// entries overwritten are count - (mask + 1).

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const bool* flag, int negate) {
  unsigned int value = *flag ? 1u : 0u;
  if (negate) value ^= 1u;
  cudaGraphSetConditional(handle, value);
}

__global__ void stamp_kernel(unsigned long long* count, int* tags, long long* ns, int tag,
                             unsigned long long mask) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  unsigned long long slot = atomicAdd(count, 1ull) & mask;
  tags[slot] = tag;
  ns[slot] = (long long)now;
}

}  // namespace

extern "C" {

int lio_stamp(void* stream, void* count, void* tags, void* ns, int tag,
              unsigned long long mask) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(count), static_cast<int*>(tags),
      static_cast<long long*>(ns), tag, mask);
  return (int)cudaGetLastError();
}

int lio_if_begin(void* parent, void* body, const void* flag, int negate) {
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaStream_t bs = static_cast<cudaStream_t>(body);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_if_kernel<<<1, 1, 0, ps>>>(handle, static_cast<const bool*>(flag), negate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(ps, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(bs, params.conditional.phGraph_out[0], nullptr,
                                            nullptr, 0, cudaStreamCaptureModeRelaxed);
}

int lio_if_end(void* body) {
  cudaGraph_t graph;
  return (int)cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
}

}  // extern "C"
