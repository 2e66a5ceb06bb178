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

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const bool* flag, int negate) {
  unsigned int value = *flag ? 1u : 0u;
  if (negate) value ^= 1u;
  cudaGraphSetConditional(handle, value);
}

}  // namespace

extern "C" {

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
