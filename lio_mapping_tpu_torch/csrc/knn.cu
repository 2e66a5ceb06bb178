// Exact k-nearest-neighbour search (k <= 8) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel lio_mapping_tpu/ops/pallas/knn_kernel.py: the
// search _knn_kernel and the _aabb prune flags that knn_pallas builds
// around it. Same function under the contract the port pins (see
// lio_mapping_tpu_torch/ops/knn.py): squared distance |q|^2 + |p|^2 - 2 q.p
// in f32, clamped at 0; ascending; ties go to the lowest map index; rows
// with fewer than k valid map points get +inf and index 0; masked queries
// get +inf and index 0. With a gate, each (256-query block, 2048-point
// chunk) tile whose AABB lower bound exceeds it is skipped, as knn_pallas
// skips it.
//
// What bounds it on this card. The arithmetic bound is tiny: the main
// path's gated 5-NN search (6144 x 24576 slots, 2395 x 11088 valid) needs
// ~12.7 M pairs at ~9 flops, 1.7 us at the 67 TFLOP/s f32 peak, below the
// cost of one launch. What costs time is latency and parallelism: voxel
// output keeps its valid rows in a prefix, so the work lives in ~24 tiles,
// and one thread per query walking 2048 points per chunk (the first
// version of this file) ran on 10 SMs as a serial compare-insert chain.
// Spread out, the search is bound by its few warps per SM waiting on
// shared-memory reads and dependent FMAs, and by the k-best inserts: a
// warp takes the insert branch whenever any of its lanes needs it.
//
// The design, two launches on the caller's stream, no host sync:
//  1. bounds_kernel: one CTA per query block and per map chunk reduces the
//     valid count, the AABB and (chunks) the index extent of the valid
//     points, and packs the map as float4 (x, y, z, |p|^2; +inf for
//     masked points, which poisons their distance). It also zeroes the
//     search's per-group counters.
//  2. search_kernel: one CTA per (32-query group, chunk), spread over all
//     SMs. It decides its tile's prune flag from the two bounds records
//     (the block's first group writes it out) and skips the search if the
//     tile is pruned (gate, or either side empty) or all 32 queries are
//     masked. Otherwise it stages the chunk's valid extent in shared
//     memory, cut into 8 contiguous sub-ranges of whole 4-point batches
//     (+inf past the extent); 8 lanes of a warp serve one query, each
//     scanning one sub-range in ascending index order, 4 independent
//     distances at a time, with a strict `<` insert into a k-best held in
//     registers. Every 32 steps the lanes of a query exchange their k-th
//     best; a point above the least of them is in no k-best of the chunk
//     and is not inserted, which spares most inserts of the lanes far from
//     the query. Three shuffle rounds merge the 8 lists, the lower
//     sub-range keeping the merge, and the query's k-best for this chunk
//     goes to scratch. Then the CTA counts its chunk done for the group;
//     the one that completes the count merges the group: 8 lanes per
//     query, each over a contiguous run of chunks in ascending order,
//     pruned chunks skipped, then the same shuffle rounds.
//
// Why the results are bit for bit those of one thread walking every kept
// point in index order: the per-pair arithmetic is the same fmaf chain;
// the flags are the same decision at the same granularity; and a strict
// `<` insert of candidates in ascending index order keeps the k smallest
// (d, index) pairs in lexicographic order. A list merged into another by
// inserting its entries in list order, all of higher index, keeps that
// invariant, so neither the sub-range nor the chunk cut moves a tie.
// Empty chunks, empty sub-ranges and masked points hold only +inf, which
// a strict `<` never inserts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 256;               // queries per prune block (the Pallas BQ)
constexpr int kBM = 2048;              // map points per chunk (the Pallas BM)
constexpr int kTPQ = 8;                // lanes per query in the search
constexpr int kQPC = 32;               // queries per search CTA
constexpr int kThreads = kTPQ * kQPC;  // 256
constexpr int kShare = 32;             // steps between threshold exchanges
constexpr int kBatch = 4;              // distances evaluated before one insert test
constexpr unsigned kFull = 0xffffffffu;

static_assert(kBQ % kQPC == 0, "a search CTA lies inside one prune block");
static_assert(32 % kTPQ == 0, "the lanes of a query lie inside one warp");
static_assert(kShare % kBatch == 0 && kBM % (kTPQ * kBatch) == 0, "whole batches");

// Per query block or map chunk: AABB of the valid points, their count and
// (chunks) the first and last valid index.
struct Bounds {
  float lo[3];
  float hi[3];
  int count;
  int first;
  int last;
  int pad[3];
};
static_assert(sizeof(Bounds) == 48, "ops/knn_kernel.py mirrors this size");

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return fmaf(x, x, fmaf(y, y, __fmul_rn(z, z)));
}

// Strict `<` insert into an ascending k-best held in registers.
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int32_t (&bi)[K], float d, int32_t idx) {
  if (d < bd[K - 1]) {
    bool placed = false;
#pragma unroll
    for (int j = K - 1; j >= 1; --j) {
      if (!placed) {
        if (d < bd[j - 1]) {
          bd[j] = bd[j - 1];
          bi[j] = bi[j - 1];
        } else {
          bd[j] = d;
          bi[j] = idx;
          placed = true;
        }
      }
    }
    if (!placed) {
      bd[0] = d;
      bi[0] = idx;
    }
  }
}

// Merge the k-best lists of the kTPQ lanes of a query (adjacent lanes, the
// lower lane holding the lower index range) into the lowest lane: in each
// round lane s inserts lane s + m's list, so on a tie the lower range wins.
// The other lanes' lists are never read again. Every lane of the warp
// takes part.
template <int K>
__device__ __forceinline__ void merge_lanes(float (&bd)[K], int32_t (&bi)[K]) {
#pragma unroll
  for (int m = 1; m < kTPQ; m <<= 1) {
    float od[K];
    int32_t oi[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      od[j] = __shfl_xor_sync(kFull, bd[j], m);
      oi[j] = __shfl_xor_sync(kFull, bi[j], m);
    }
#pragma unroll
    for (int j = 0; j < K; ++j) insert<K>(bd, bi, od[j], oi[j]);
  }
}

// The tile's prune flag, decided as ops/knn_kernel.py::prune_flags decides
// it: either side empty, or the AABB lower bound (g0^2 + g2^2) + g1^2 above
// the gate (or NaN). That is the order PyTorch's CUDA sum over a last axis
// of 3 adds in, so the flags are those the first version of this kernel got
// from torch.sum; the _rn intrinsics keep nvcc from contracting an FMA.
__device__ __forceinline__ bool tile_pruned(const Bounds& q, const Bounds& c, float gate) {
  if (q.count == 0 || c.count == 0) return true;
  float g[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) g[a] = fmaxf(0.f, fmaxf(q.lo[a] - c.hi[a], c.lo[a] - q.hi[a]));
  const float lb = __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[2], g[2])),
                             __fmul_rn(g[1], g[1]));
  return !(lb <= gate);
}

__global__ void __launch_bounds__(256)
bounds_kernel(const float* __restrict__ queries, const uint8_t* __restrict__ q_mask,
              const float* __restrict__ db, const uint8_t* __restrict__ db_mask, int n_q,
              int n_m, int n_qb, int n_groups, float4* __restrict__ db4,
              Bounds* __restrict__ bounds, int* __restrict__ done) {
  __shared__ float s_lo[8][3], s_hi[8][3];
  __shared__ int s_count[8], s_first[8], s_last[8];

  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < n_groups) done[g] = 0;

  const bool is_q = blockIdx.x < n_qb;
  const int size = is_q ? kBQ : kBM;
  const int base = (is_q ? blockIdx.x : blockIdx.x - n_qb) * size;
  const int end = min(base + size, is_q ? n_q : n_m);
  const float* pts = is_q ? queries : db;
  const uint8_t* mask = is_q ? q_mask : db_mask;

  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  int count = 0, first = INT32_MAX, last = -1;
  for (int m = base + threadIdx.x; m < end; m += blockDim.x) {
    const float x = pts[3 * m + 0], y = pts[3 * m + 1], z = pts[3 * m + 2];
    const bool v = mask[m] != 0;
    if (v) {
      lo[0] = fminf(lo[0], x); lo[1] = fminf(lo[1], y); lo[2] = fminf(lo[2], z);
      hi[0] = fmaxf(hi[0], x); hi[1] = fmaxf(hi[1], y); hi[2] = fmaxf(hi[2], z);
      ++count;
      first = min(first, m);
      last = max(last, m);
    }
    if (!is_q) {
      db4[m] = v ? make_float4(x, y, z, sq_norm(x, y, z)) : make_float4(0.f, 0.f, 0.f, INFINITY);
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], off));
    }
    count += __shfl_xor_sync(kFull, count, off);
    first = min(first, __shfl_xor_sync(kFull, first, off));
    last = max(last, __shfl_xor_sync(kFull, last, off));
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s_lo[warp][a] = lo[a];
      s_hi[warp][a] = hi[a];
    }
    s_count[warp] = count;
    s_first[warp] = first;
    s_last[warp] = last;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Bounds out;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      out.lo[a] = s_lo[0][a];
      out.hi[a] = s_hi[0][a];
    }
    out.count = s_count[0];
    out.first = s_first[0];
    out.last = s_last[0];
    for (int w = 1; w < blockDim.x / 32; ++w) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        out.lo[a] = fminf(out.lo[a], s_lo[w][a]);
        out.hi[a] = fmaxf(out.hi[a], s_hi[w][a]);
      }
      out.count += s_count[w];
      out.first = min(out.first, s_first[w]);
      out.last = max(out.last, s_last[w]);
    }
    out.pad[0] = out.pad[1] = out.pad[2] = 0;
    bounds[blockIdx.x] = out;
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
search_kernel(const float* __restrict__ queries, const uint8_t* __restrict__ q_mask,
              const float4* __restrict__ db4, const Bounds* __restrict__ bounds, int n_q,
              int n_qb, int n_ch, float gate, uint8_t* __restrict__ flags,
              int* __restrict__ done, float* __restrict__ part_d, int32_t* __restrict__ part_i,
              float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  // the chunk's valid extent, sub-range s at s * stride, each padded with
  // +inf points to a whole number of batches; an odd stride puts the 8
  // lanes of a query on distinct banks
  __shared__ float4 pts[kBM + kTPQ];
  __shared__ bool merges;

  const int group = blockIdx.x;
  const int c = blockIdx.y;
  const int b = group * kQPC / kBQ;
  const Bounds cb = bounds[n_qb + c];
  const bool pruned = tile_pruned(bounds[b], cb, gate);
  if (threadIdx.x == 0 && (group * kQPC) % kBQ == 0) flags[b * n_ch + c] = pruned ? 1 : 0;

  const int qi = group * kQPC + threadIdx.x / kTPQ;
  const int s = threadIdx.x % kTPQ;
  const bool live = qi < n_q && q_mask[qi] != 0;
  float bd[K];
  int32_t bi[K];
  // (pruned is the same for the whole CTA)
  if (!pruned && __syncthreads_or(live)) {
    const int first = cb.first;
    const int n = cb.last + 1 - first;
    const int len = ((n + kTPQ - 1) / kTPQ + kBatch - 1) / kBatch * kBatch;
    const int stride = len + 1;
    for (int t = threadIdx.x; t < kTPQ * len; t += kThreads) {
      pts[t / len * stride + t % len] =
          t < n ? db4[first + t] : make_float4(0.f, 0.f, 0.f, INFINITY);
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < K; ++j) {
      bd[j] = INFINITY;
      bi[j] = 0;
    }
    const float qx = live ? queries[3 * qi + 0] : 0.f;
    const float qy = live ? queries[3 * qi + 1] : 0.f;
    const float qz = live ? queries[3 * qi + 2] : 0.f;
    const float q_sq = sq_norm(qx, qy, qz);
    const int cnt = live ? len : 0;
    const float4* sp = pts + s * stride;
    const int32_t base = first + s * len;
    // thr: the least k-th best over the query's lanes. Some lane holds k
    // points at or below it, so a point above it is in no k-best of this
    // chunk and need not be inserted; one at or below it still is (ties).
    // (with k = 1 the insert is one compare: no exchange)
    constexpr int share = K > 1 ? kShare : kBM;
    float thr = INFINITY;
    for (int t0 = 0; t0 < len; t0 += share) {
      const int t1 = min(t0 + share, cnt);
      for (int t = t0; t < t1; t += kBatch) {
        // kBatch independent distances, then one test for the batch: the
        // least of them passes it if and only if any of them may insert
        float d[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const float4 p = sp[t + u];
          const float dot = fmaf(qx, p.x, fmaf(qy, p.y, __fmul_rn(qz, p.z)));
          d[u] = fmaxf(fmaf(-2.f, dot, __fadd_rn(q_sq, p.w)), 0.f);
        }
        float least = d[0];
#pragma unroll
        for (int u = 1; u < kBatch; ++u) least = fminf(least, d[u]);
        if (least < bd[K - 1] && least <= thr) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (d[u] <= thr) insert<K>(bd, bi, d[u], base + t + u);
          }
        }
      }
      thr = bd[K - 1];
#pragma unroll
      for (int m = 1; m < kTPQ; m <<= 1) thr = fminf(thr, __shfl_xor_sync(kFull, thr, m));
    }

    merge_lanes<K>(bd, bi);
    if (live && s == 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        part_d[(c * K + j) * n_q + qi] = bd[j];
        part_i[(c * K + j) * n_q + qi] = bi[j];
      }
      __threadfence();  // the list is visible before the count below
    }
  }

  // This chunk is done for the group; the CTA that completes the group's
  // count merges its chunks. The merge order is the chunk order, so which
  // CTA completes the count changes no bit.
  __syncthreads();
  if (threadIdx.x == 0) merges = atomicAdd(&done[group], 1) == n_ch - 1;
  __syncthreads();
  if (!merges) return;
  __threadfence();

  // 8 lanes per query again: lane s inserts the lists of a contiguous run
  // of chunks in ascending order, pruned chunks skipped; then the lanes
  // merge as above. Lists are read through L2 (other SMs wrote them).
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = INFINITY;
    bi[j] = 0;
  }
  if (live) {
    const int per_lane = (n_ch + kTPQ - 1) / kTPQ;
    const int c1 = min(n_ch, (s + 1) * per_lane);
    for (int cc = s * per_lane; cc < c1; ++cc) {
      if (tile_pruned(bounds[b], bounds[n_qb + cc], gate)) continue;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        insert<K>(bd, bi, __ldcg(part_d + (cc * K + j) * n_q + qi),
                  __ldcg(part_i + (cc * K + j) * n_q + qi));
      }
    }
  }
  merge_lanes<K>(bd, bi);
  if (qi < n_q && s == 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      out_d[qi * K + j] = bd[j];
      out_i[qi * K + j] = bi[j];
    }
  }
}

__global__ void noop_kernel() {}

template <int K>
cudaError_t launch_search(const float* q, const uint8_t* qm, const float4* db4,
                          const Bounds* bounds, int n_q, int n_qb, int n_ch, float gate,
                          uint8_t* flags, int* done, float* part_d, int32_t* part_i,
                          float* out_d, int32_t* out_i, cudaStream_t stream) {
  const dim3 grid((n_q + kQPC - 1) / kQPC, n_ch);
  search_kernel<K><<<grid, kThreads, 0, stream>>>(q, qm, db4, bounds, n_q, n_qb, n_ch, gate,
                                                  flags, done, part_d, part_i, out_d, out_i);
  return cudaGetLastError();
}

size_t align16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

}  // namespace

// Scratch bytes one search needs: the tile flags, the per-group done
// counters, the bounds records, the packed map and the per-chunk k-best
// lists (ops/knn_kernel.py::scratch_bytes mirrors it).
extern "C" size_t lio_knn_scratch_bytes(int n_q, int n_m, int k) {
  const size_t n_qb = (n_q + kBQ - 1) / kBQ, n_ch = (n_m + kBM - 1) / kBM;
  const size_t n_groups = (n_q + kQPC - 1) / kQPC;
  return align16(n_qb * n_ch) + align16(n_groups * sizeof(int)) +
         align16((n_qb + n_ch) * sizeof(Bounds)) +
         align16(n_m * sizeof(float4)) + align16(n_ch * k * n_q * sizeof(float)) +
         n_ch * k * n_q * sizeof(int32_t);
}

// One search, all of it enqueued on `stream` (bound with ctypes; every
// pointer is a device pointer). `gate` is the squared-distance prune gate,
// +inf for none (then only empty tiles are skipped). Writes (n_q, k)
// distances and indices, and at the start of `scratch` the
// (ceil(n_q/256), ceil(n_m/2048)) uint8 tile flags (1 = skipped). Returns
// a cudaError_t as an int.
extern "C" int lio_knn_f32(const void* queries, const void* q_mask, const void* db,
                           const void* db_mask, int n_q, int n_m, int k, float gate,
                           void* out_d, void* out_i, void* scratch, size_t scratch_bytes,
                           void* stream) {
  if (k < 1 || k > 8 || n_q < 1 || n_m < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (scratch_bytes < lio_knn_scratch_bytes(n_q, n_m, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qb = (n_q + kBQ - 1) / kBQ, n_ch = (n_m + kBM - 1) / kBM;
  const int n_groups = (n_q + kQPC - 1) / kQPC;
  char* p = static_cast<char*>(scratch);
  uint8_t* fl = reinterpret_cast<uint8_t*>(p);
  p += align16(static_cast<size_t>(n_qb) * n_ch);
  int* done = reinterpret_cast<int*>(p);
  p += align16(static_cast<size_t>(n_groups) * sizeof(int));
  Bounds* bounds = reinterpret_cast<Bounds*>(p);
  p += align16((n_qb + n_ch) * sizeof(Bounds));
  float4* db4 = reinterpret_cast<float4*>(p);
  p += align16(static_cast<size_t>(n_m) * sizeof(float4));
  float* part_d = reinterpret_cast<float*>(p);
  p += align16(static_cast<size_t>(n_ch) * k * n_q * sizeof(float));
  int32_t* part_i = reinterpret_cast<int32_t*>(p);

  const float* q = static_cast<const float*>(queries);
  const uint8_t* qm = static_cast<const uint8_t*>(q_mask);
  float* od = static_cast<float*>(out_d);
  int32_t* oi = static_cast<int32_t*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  bounds_kernel<<<n_qb + n_ch, 256, 0, s>>>(q, qm, static_cast<const float*>(db),
                                            static_cast<const uint8_t*>(db_mask), n_q, n_m,
                                            n_qb, n_groups, db4, bounds, done);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  using Launch = decltype(&launch_search<1>);
  constexpr Launch kLaunch[8] = {launch_search<1>, launch_search<2>, launch_search<3>,
                                 launch_search<4>, launch_search<5>, launch_search<6>,
                                 launch_search<7>, launch_search<8>};
  err = kLaunch[k - 1](q, qm, db4, bounds, n_q, n_qb, n_ch, gate, fl, done, part_d, part_i, od,
                       oi, s);
  return static_cast<int>(err);
}

// One empty kernel on `stream`: the launch cost a timing loop measures
// beside the search.
extern "C" int lio_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
