// Batched dense solve A x = b of small systems (n <= 128) by LU with
// partial pivoting, float32 or float64: one CTA per system, each row of
// [A | b] held in registers by its own thread(s), nothing read back to the
// host.
//
// It replaces the `jnp.linalg.solve` calls of the reference step, which XLA
// runs inside its one program per sweep (not Pallas kernels):
//   lio_mapping_tpu/models/estimator.py:369   the mini-GN's 6x6 step
//   lio_mapping_tpu/ops/solver.py:397         the window LM's damped system,
//                                             (15 (S + 1) + 6)^2: 126 indoor,
//                                             96 outdoor_64
// (and the odometry's and mapping's 6x6 steps, odometry.py:212, mapping.py:211).
// The step's conditional bodies need it: torch's solve goes to cuSOLVER,
// whose getrf allocates stream-ordered memory (cudaMallocAsync) when it is
// captured on another stream than its last call, and a CUDA graph's
// conditional body may hold no allocation node.
//
// What bounds it: latency. A system is O(n^2) bytes and (2/3) n^3 flops,
// far below the card's rates; the time is the chain of barrier-separated
// steps. So the matrix never goes through shared memory: thread i keeps row
// i of [A | b] in registers (R = 4 threads a row for float64 at n > 64, so
// that a row fits: 33 doubles each), and the kernel is a template on the
// padded order NP (8, 16, 32, 64, 128) with the column loop unrolled, so
// that the row is indexed statically. A column takes two barriers: the
// warps' pivot candidates (each warp's by two warp reductions, redux.sync,
// in place of a tree of shuffles), then the pivot row, which its thread
// writes to shared memory in 16-byte stores; back substitution one a row.
//
// Algorithm, as LAPACK's getrf + getrs and bit for bit the earlier
// shared-memory kernel's (the same operations in the same order, the same
// FMA contraction): at column k the pivot is the row of largest |a_ik|
// among those not yet pivoted, the first in LAPACK's row order on a tie
// (isamax's rule; a NaN is never chosen; none: the row at position k).
// Rows are never swapped: each thread carries its row's position in that
// order (the pivot takes position k, the row that was there the pivot's).
// Every remaining row forms l = a_ik / a_kk and a_ij -= l a_kj for j > k
// (b as column NP); a zero pivot leaves its column as it is and the back
// substitution divides by it, so a singular system gives non-finite
// entries, as LAPACK's does. Then x_i = (b_i - sum_{j > i} u_ij x_j) / u_ii,
// one column at a time, x_i broadcast through shared memory.
// Deterministic: each value is computed by one fixed thread, no atomics.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kMaxN = 128;
constexpr unsigned kAll = 0xffffffffu;

// NP: the padded order (n <= NP); R: threads a row, each holding columns
// j = part + R q of [A | 0 | b] (b at column NP)
template <typename T, int NP, int R>
struct Shape {
  static constexpr int kCols = (NP + 1 + R - 1) / R;
  static constexpr int kThreads = NP * R < 32 ? 32 : NP * R;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kBPart = NP % R;
  static constexpr int kBSlot = NP / R;
};

// the warp's candidate (largest |a|, then smallest position) by warp
// reductions of the value's bits (|a| >= 0 orders as its bit pattern) and
// of the position; false when no lane has one
__device__ __forceinline__ bool warp_argmax(bool valid, float av, int pos, float& v, int& p) {
  if (!__any_sync(kAll, valid)) return false;
  const unsigned bits = valid ? __float_as_uint(av) : 0u;
  const unsigned top = __reduce_max_sync(kAll, bits);
  p = (int)__reduce_min_sync(kAll, valid && bits == top ? (unsigned)pos : ~0u);
  v = __uint_as_float(top);
  return true;
}

__device__ __forceinline__ bool warp_argmax(bool valid, double av, int pos, double& v, int& p) {
  if (!__any_sync(kAll, valid)) return false;
  const unsigned long long bits = valid ? (unsigned long long)__double_as_longlong(av) : 0ull;
  const unsigned hi = (unsigned)(bits >> 32), lo = (unsigned)bits;
  const unsigned top_hi = __reduce_max_sync(kAll, hi);
  const unsigned top_lo = __reduce_max_sync(kAll, valid && hi == top_hi ? lo : 0u);
  p = (int)__reduce_min_sync(kAll, valid && hi == top_hi && lo == top_lo ? (unsigned)pos : ~0u);
  v = __longlong_as_double((long long)(((unsigned long long)top_hi << 32) | top_lo));
  return true;
}

template <typename T, int NP, int R>
__global__ void __launch_bounds__(Shape<T, NP, R>::kThreads)
lu_solve_kernel(const T* __restrict__ a_in, const T* __restrict__ b_in, T* __restrict__ x_out,
                int n) {
  using S = Shape<T, NP, R>;
  constexpr int kVec = 16 / sizeof(T);               // values a 16-byte access moves
  constexpr int kChunks = (S::kCols * R + kVec - 1) / kVec;
  __shared__ __align__(16) T prow[kChunks * kVec];  // the pivot row, by column
  __shared__ T cand_v[S::kWarps];
  __shared__ int cand_p[S::kWarps];
  __shared__ T xs[NP];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int i = tid / R;     // this thread's row
  const int part = tid % R;  // its columns: part + R q
  const int lead = lane - part;
  const bool live = i < n;
  const T* a = a_in + (size_t)blockIdx.x * n * n;
  const T* b = b_in + (size_t)blockIdx.x * n;

  T row[S::kCols];
#pragma unroll
  for (int q = 0; q < S::kCols; ++q) {
    const int j = part + R * q;
    row[q] = T(0);
    if (live && j < n) row[q] = a[i * n + j];
    if (live && j == NP) row[q] = b[i];
  }
  int pos = i;  // the row's position in LAPACK's row order

#pragma unroll
  for (int k = 0; k < NP; ++k) {
    if (k >= n) break;
    T aik = row[k / R];
    if (R > 1) aik = __shfl_sync(kAll, aik, lead + k % R);
    // pivot: the largest |a_ik| of the rows not yet pivoted, the first
    // position on a tie, never a NaN
    const T av = aik < T(0) ? -aik : (aik == T(0) ? T(0) : aik);
    T wv = T(0);
    int wp = 0;
    const bool found = warp_argmax(live && pos >= k && av == av, av, pos, wv, wp);
    if (lane == 0) {
      cand_v[warp] = wv;
      cand_p[warp] = found ? wp : -1;
    }
    __syncthreads();
    int p = -1;
    T pv = T(0);
#pragma unroll
    for (int w = 0; w < S::kWarps; ++w) {
      const int op = cand_p[w];
      const T ov = cand_v[w];
      if (op >= 0 && (p < 0 || ov > pv || (ov == pv && op < p))) {
        p = op;
        pv = ov;
      }
    }
    if (p < 0) p = k;
    if (live && pos == p) {
      if constexpr (R == 1) {
#pragma unroll
        for (int t = 0; t < S::kCols / kVec; ++t) {
          if constexpr (sizeof(T) == 4)
            reinterpret_cast<float4*>(prow)[t] =
                make_float4(row[4 * t], row[4 * t + 1], row[4 * t + 2], row[4 * t + 3]);
          else
            reinterpret_cast<double2*>(prow)[t] = make_double2(row[2 * t], row[2 * t + 1]);
        }
#pragma unroll
        for (int q = S::kCols / kVec * kVec; q < S::kCols; ++q) prow[q] = row[q];
      } else {
#pragma unroll
        for (int q = 0; q < S::kCols; ++q) prow[part + R * q] = row[q];
      }
    }
    pos = (pos == p) ? k : (pos == k ? p : pos);
    __syncthreads();
    const T piv = prow[k];
    if (piv != T(0) && live && pos > k) {
      const T l = aik / piv;
      if constexpr (R == 1) {
#pragma unroll
        for (int t = 0; t < kChunks; ++t) {
          if ((t + 1) * kVec <= k + 1) continue;  // columns <= k only
          T pr[kVec];
          if constexpr (sizeof(T) == 4) {
            const float4 v4 = reinterpret_cast<const float4*>(prow)[t];
            pr[0] = v4.x;
            pr[1] = v4.y;
            pr[2] = v4.z;
            pr[3] = v4.w;
          } else {
            const double2 v2 = reinterpret_cast<const double2*>(prow)[t];
            pr[0] = v2.x;
            pr[1] = v2.y;
          }
#pragma unroll
          for (int u = 0; u < kVec; ++u) {
            const int j = t * kVec + u;
            if (j > k && j < S::kCols) row[j] -= l * pr[u];
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < S::kCols; ++q) {
          const int j = part + R * q;
          if (j > k && j <= NP) row[q] -= l * prow[j];
        }
      }
    }
  }

  // back substitution: the row at position c holds u_c., column by column
#pragma unroll
  for (int c = NP - 1; c >= 0; --c) {
    if (c >= n) continue;
    T u = row[c / R];
    if (R > 1) u = __shfl_sync(kAll, u, lead + c % R);
    if (live && pos == c && part == S::kBPart) xs[c] = row[S::kBSlot] / u;
    __syncthreads();
    if (live && pos < c && part == S::kBPart) row[S::kBSlot] -= u * xs[c];
  }
  T* x = x_out + (size_t)blockIdx.x * n;
  for (int j = tid; j < n; j += S::kThreads) x[j] = xs[j];
}

template <typename T, int NP, int R>
int launch_np(const T* a, const T* b, T* x, int batch, int n, cudaStream_t stream) {
  lu_solve_kernel<T, NP, R><<<batch, Shape<T, NP, R>::kThreads, 0, stream>>>(a, b, x, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* a_, const void* b_, void* x_, int batch, int n, void* stream_) {
  if (n < 1 || n > kMaxN || batch < 1) return (int)cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(a_);
  const T* b = static_cast<const T*>(b_);
  T* x = static_cast<T*>(x_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  constexpr int kR = sizeof(T) == 8 ? 4 : 1;  // float64 at NP = 128: four threads a row
  if (n <= 8) return launch_np<T, 8, 1>(a, b, x, batch, n, stream);
  if (n <= 16) return launch_np<T, 16, 1>(a, b, x, batch, n, stream);
  if (n <= 32) return launch_np<T, 32, 1>(a, b, x, batch, n, stream);
  if (n <= 64) return launch_np<T, 64, 1>(a, b, x, batch, n, stream);
  return launch_np<T, 128, kR>(a, b, x, batch, n, stream);
}

}  // namespace

extern "C" {

int lio_lu_solve_max_n(void) { return kMaxN; }

// a (batch, n, n) row-major, b and x (batch, n); float32 (f32) or float64
// (f64). Returns the launch's cudaError_t (0: enqueued).
int lio_lu_solve_f32(const void* a, const void* b, void* x, int batch, int n, void* stream) {
  return launch<float>(a, b, x, batch, n, stream);
}

int lio_lu_solve_f64(const void* a, const void* b, void* x, int batch, int n, void* stream) {
  return launch<double>(a, b, x, batch, n, stream);
}

}  // extern "C"
