// Batched dense solve A x = b of small systems (n <= 128) by LU with
// partial pivoting, float32 or float64: one CTA per system, the augmented
// matrix [A | b] in shared memory, nothing read back to the host.
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
// steps: per column a pivot search (one warp), the row swap and the
// multipliers, the trailing update; then n back-substitution steps.
//
// Algorithm, as LAPACK's getrf + getrs: at column k the pivot is the first
// row i >= k of largest |a_ik| (isamax's rule; a NaN is never chosen), rows
// k and p swap (columns k .. n, b included), the multipliers l_ik = a_ik /
// a_kk, then a_ij -= l_ik a_kj for i, j > k (b as column n); a zero pivot
// leaves its column as it is and the back substitution divides by it, so
// a singular system gives non-finite entries, as LAPACK's does. Then
// x_i = (b_i - sum_{j > i} u_ij x_j) / u_ii, one column at a time.
// Deterministic: each element is written by one fixed thread, no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kThreads = 512;
constexpr int kMaxDevices = 64;

__host__ __device__ inline size_t shared_bytes(int n, size_t elem) {
  return elem * (size_t)n * (n + 1);
}

template <typename T>
__device__ inline T abs_of(T v) {
  return v < T(0) ? -v : v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lu_solve_kernel(const T* __restrict__ a_in, const T* __restrict__ b_in, T* __restrict__ x_out,
                int n) {
  extern __shared__ unsigned char smem_raw[];
  T* M = reinterpret_cast<T*>(smem_raw);  // n rows of [A | b]
  __shared__ int pivot_row;
  const int ld = n + 1;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const T* a = a_in + (size_t)blockIdx.x * n * n;
  const T* b = b_in + (size_t)blockIdx.x * n;

  for (int idx = tid; idx < n * ld; idx += nt) {
    const int i = idx / ld, j = idx - (idx / ld) * ld;
    M[idx] = (j < n) ? a[i * n + j] : b[i];
  }
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    // pivot: the first row of largest |a_ik|, i >= k (warp 0)
    if (tid < 32) {
      int best = -1;
      T best_v = T(0);
      for (int i = k + lane; i < n; i += 32) {
        const T v = abs_of(M[i * ld + k]);
        if (best < 0 ? (v == v) : (v > best_v)) {
          best = i;
          best_v = v;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const int o_best = __shfl_down_sync(0xffffffffu, best, off);
        const T o_v = __shfl_down_sync(0xffffffffu, best_v, off);
        const bool take = o_best >= 0 &&
                          (best < 0 || o_v > best_v || (o_v == best_v && o_best < best));
        if (take) {
          best = o_best;
          best_v = o_v;
        }
      }
      if (lane == 0) pivot_row = best < 0 ? k : best;
    }
    __syncthreads();
    const int p = pivot_row;
    if (p != k) {
      for (int j = k + tid; j <= n; j += nt) {
        const T t = M[k * ld + j];
        M[k * ld + j] = M[p * ld + j];
        M[p * ld + j] = t;
      }
      __syncthreads();
    }
    const T piv = M[k * ld + k];
    if (piv != T(0)) {
      for (int i = k + 1 + tid; i < n; i += nt) M[i * ld + k] = M[i * ld + k] / piv;
      __syncthreads();
      const int rows = n - k - 1, cols = n - k;  // columns k+1 .. n (b included)
      for (int idx = tid; idx < rows * cols; idx += nt) {
        const int i = k + 1 + idx / cols, j = k + 1 + (idx - (idx / cols) * cols);
        M[i * ld + j] -= M[i * ld + k] * M[k * ld + j];
      }
    }
    __syncthreads();
  }

  // back substitution, one column of U at a time; x lands in column n
  for (int i = n - 1; i >= 0; --i) {
    if (tid == 0) M[i * ld + n] = M[i * ld + n] / M[i * ld + i];
    __syncthreads();
    const T xi = M[i * ld + n];
    for (int r = tid; r < i; r += nt) M[r * ld + n] -= M[r * ld + i] * xi;
    __syncthreads();
  }
  T* x = x_out + (size_t)blockIdx.x * n;
  for (int i = tid; i < n; i += nt) x[i] = M[i * ld + n];
}

bool g_attr_set[2][kMaxDevices] = {};

template <typename T>
int launch(const void* a, const void* b, void* x, int batch, int n, void* stream, int which) {
  if (n < 1 || n > kMaxN || batch < 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!g_attr_set[which][dev]) {
    err = cudaFuncSetAttribute(lu_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shared_bytes(kMaxN, sizeof(T)));
    if (err != cudaSuccess) return (int)err;
    g_attr_set[which][dev] = true;
  }
  int threads = ((n * (n + 1) + 31) / 32) * 32;
  if (threads > kThreads) threads = kThreads;
  if (threads < 32) threads = 32;
  lu_solve_kernel<T><<<batch, threads, shared_bytes(n, sizeof(T)),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(x), n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lio_lu_solve_max_n(void) { return kMaxN; }

// a (batch, n, n) row-major, b and x (batch, n); float32 (f32) or float64
// (f64). Returns the launch's cudaError_t (0: enqueued).
int lio_lu_solve_f32(const void* a, const void* b, void* x, int batch, int n, void* stream) {
  return launch<float>(a, b, x, batch, n, stream, 0);
}

int lio_lu_solve_f64(const void* a, const void* b, void* x, int batch, int n, void* stream) {
  return launch<double>(a, b, x, batch, n, stream, 1);
}

}  // extern "C"
