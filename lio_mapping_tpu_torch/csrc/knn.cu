// Exact k-nearest-neighbour search (k <= 8) for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel lio_mapping_tpu/ops/pallas/knn_kernel.py
// (_knn_kernel, launched by knn_pallas). Same function under the contract
// the port pins (see lio_mapping_tpu_torch/ops/knn.py): squared distance
// |q|^2 + |p|^2 - 2 q.p in f32, clamped at 0; ascending; ties go to the
// lowest map index; rows with fewer than k valid map points get +inf and
// index 0. Query-block x chunk pairs flagged in `prune` are skipped (the
// wrapper's AABB gate, as knn_pallas does it).
//
// What bounds it on this card: arithmetic. One call on the main path
// (6144 queries x 24576 map points) is ~151 M pair evaluations at ~9 FLOP
// each (3 FMAs for q.p, an add, a final FMA), ~1.4 GFLOP, against a map
// read of ~300 KB that is negligible: ~0.02 ms at the 67 TFLOP/s f32
// (non-tensor-core) peak. The design keeps every pair on the FMA pipes
// with no memory traffic in the inner loop: each chunk of 2048 map points
// is staged once per block in shared memory as float4 (x, y, z, |p|^2;
// +inf for masked/padded points, which poisons their distance), every
// thread owns one query and keeps its k best (d, idx) in registers
// (K is a template parameter, so the insertion network is unrolled).
// Chunks run in ascending index order and insertion is strict `<`, so the
// lowest index wins ties without any extra compare.
//
// Known slowness (first version): one thread per query in blocks of 256
// (the Pallas BQ, so the prune flags keep their granularity) gives
// 6144 / 256 = 24 blocks, which fill only 24 of the 132 SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 256;   // queries per block (one per thread)
constexpr int kBM = 2048;  // map points per shared-memory chunk

template <int K>
__global__ void __launch_bounds__(kBQ)
knn_kernel(const float* __restrict__ queries, const float* __restrict__ db,
           const uint8_t* __restrict__ db_mask, const uint8_t* __restrict__ prune,
           int n_q, int n_m, int n_chunks, float* __restrict__ out_d,
           int32_t* __restrict__ out_i) {
  __shared__ float4 chunk[kBM];

  const int qi = blockIdx.x * kBQ + threadIdx.x;
  const bool live = qi < n_q;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = queries[3 * qi + 0];
    qy = queries[3 * qi + 1];
    qz = queries[3 * qi + 2];
  }
  const float q_sq = fmaf(qx, qx, fmaf(qy, qy, qz * qz));

  float bd[K];
  int32_t bi[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    bd[j] = INFINITY;
    bi[j] = 0;
  }

  for (int c = 0; c < n_chunks; ++c) {
    // block-uniform skip: every thread reads the same flag
    if (prune != nullptr && prune[blockIdx.x * n_chunks + c]) continue;
    const int base = c * kBM;
    __syncthreads();  // the previous chunk is fully consumed
    for (int t = threadIdx.x; t < kBM; t += kBQ) {
      const int m = base + t;
      float4 p = make_float4(0.f, 0.f, 0.f, INFINITY);
      if (m < n_m && db_mask[m]) {
        p.x = db[3 * m + 0];
        p.y = db[3 * m + 1];
        p.z = db[3 * m + 2];
        p.w = fmaf(p.x, p.x, fmaf(p.y, p.y, p.z * p.z));
      }
      chunk[t] = p;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBM; ++t) {
      const float4 p = chunk[t];
      const float dot = fmaf(qx, p.x, fmaf(qy, p.y, qz * p.z));
      const float d = fmaxf(fmaf(-2.f, dot, q_sq + p.w), 0.f);
      if (d < bd[K - 1]) {
        const int32_t idx = base + t;
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
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      out_d[qi * K + j] = bd[j];
      out_i[qi * K + j] = bi[j];
    }
  }
}

template <int K>
void launch(const float* q, const float* db, const uint8_t* db_mask, const uint8_t* prune,
            int n_q, int n_m, float* out_d, int32_t* out_i, cudaStream_t stream) {
  const int n_qb = (n_q + kBQ - 1) / kBQ;
  const int n_ch = (n_m + kBM - 1) / kBM;
  knn_kernel<K><<<n_qb, kBQ, 0, stream>>>(q, db, db_mask, prune, n_q, n_m, n_ch, out_d, out_i);
}

}  // namespace

// Plain C entry point (bound with ctypes). All pointers are device
// pointers; `prune` is a (ceil(n_q/256), ceil(n_m/2048)) uint8 array or
// null. Launches on `stream` and returns cudaGetLastError() as an int.
extern "C" int lio_knn_f32(const void* queries, const void* db, const void* db_mask,
                           const void* prune, int n_q, int n_m, int k, void* out_d,
                           void* out_i, void* stream) {
  const float* q = static_cast<const float*>(queries);
  const float* p = static_cast<const float*>(db);
  const uint8_t* pm = static_cast<const uint8_t*>(db_mask);
  const uint8_t* pr = static_cast<const uint8_t*>(prune);
  float* od = static_cast<float*>(out_d);
  int32_t* oi = static_cast<int32_t*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch<1>(q, p, pm, pr, n_q, n_m, od, oi, s); break;
    case 2: launch<2>(q, p, pm, pr, n_q, n_m, od, oi, s); break;
    case 3: launch<3>(q, p, pm, pr, n_q, n_m, od, oi, s); break;
    case 4: launch<4>(q, p, pm, pr, n_q, n_m, od, oi, s); break;
    case 5: launch<5>(q, p, pm, pr, n_q, n_m, od, oi, s); break;
    case 6: launch<6>(q, p, pm, pr, n_q, n_m, od, oi, s); break;
    case 7: launch<7>(q, p, pm, pr, n_q, n_m, od, oi, s); break;
    case 8: launch<8>(q, p, pm, pr, n_q, n_m, od, oi, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
