// Batched symmetric eigendecomposition of small matrices by parallel cyclic
// Jacobi: one CTA per matrix, the whole decision inside the kernel, nothing
// read back to the host. float32 (n <= 128; the step's type) and float64
// (n <= 118, what 227 KB of shared memory holds; the float64 pipeline of
// tools/debug_corner). The matrix is kept in its own type; the rotations
// and the eigenvectors in float64: in float32 the ~2 sweeps x n rotations
// that touch each vector element lost ~2e-5 of orthogonality at n = 111,
// and with it the prior's J^T J on a real sweep's Schur complement.
//
// It replaces the `jnp.linalg.eigh` calls of the reference step, which XLA
// runs inside its one program per sweep (not Pallas kernels):
//   lio_mapping_tpu/ops/gn.py:31                  the 6x6 A^T A of the mini-GN's
//                                                 degeneracy projection (round 0)
//   lio_mapping_tpu/ops/marginalization.py:119    the equilibrated 15x15 A_mm
//   lio_mapping_tpu/ops/marginalization.py:155    the (15 S + 6)^2 Schur complement
//                                                 that becomes the prior (111 indoor,
//                                                 81 outdoor_64)
// `torch.linalg.eigh` reads LAPACK's status back on every call (a host sync),
// so a step that reads nothing back needs its own kernel.
//
// Why Jacobi: the Schur complements carry bias blocks near 1e12 before the
// cancellation, and the prior keeps the eigenvalues above an absolute 1e-8;
// Jacobi with the relative off-diagonal test below computes the small
// eigenvalues of such graded matrices to high relative accuracy.
//
// What bounds it: latency. A matrix is O(n^2) bytes and O(sweeps n^3) flops
// (~9 n^3 a sweep), far below the card's rates at these sizes; the time is
// the chain of barrier-separated steps, 2 (n + n % 2 - 1) a sweep, each a
// few shared-memory updates per thread. One CTA per matrix keeps the matrix
// and the eigenvector accumulator in shared memory for the whole run.
//
// Algorithm (ops/eigh.py::eigh_jacobi_reference repeats it step by step):
//   * A = the lower triangle of the input mirrored (as torch.linalg.eigh
//     reads it), padded to an even order m with a zero row and column that
//     never rotate; V = I (float64).
//   * A sweep is m - 1 steps of the round-robin (circle) pairing: step r
//     pairs (r, m - 1) and ((r + k) mod (m - 1), (r - k) mod (m - 1)) for
//     k = 1 .. m/2 - 1, so each index pair meets once a sweep and the m/2
//     rotations of a step are disjoint.
//   * Pair (p, q), p < q, rotates when |a_pq| > tol sqrt|a_pp| sqrt|a_qq|
//     (tol = the matrix type's epsilon times sqrt(n); the test and the
//     rotation in float64 from A's values); tau = (a_qq - a_pp) / (2 a_pq),
//     t = sign(tau) / (|tau| + hypot(1, tau)), c = 1 / sqrt(1 + t^2), s = t c
//     (Golub & Van Loan's symSchur2). Row rotations (A <- J^T A), a barrier,
//     column rotations (A <- A J, V <- V J) with the pair's 2x2 block set to
//     diag(a_pp - t a_pq, a_qq + t a_pq), each new element of A computed in
//     float64 and rounded to A's type once, a barrier. Pair k belongs to warp
//     k mod W (W = min(16, m/2) warps), which computes its rotation itself.
//   * The kernel stops after the first sweep without a rotation, or after
//     `max_sweeps` sweeps.
//   * The eigenvalues (the diagonal) are sorted ascending with their
//     vectors, ties by index (NaNs last): a rank per value, no atomics.
// Deterministic: each element is written by one fixed thread, plain
// arithmetic in the matrix's type, no atomics. Built with --fmad=false (no
// FMA contraction; ops/eigh.py::build), so that each operation rounds as
// the same torch operation on the card does: eigh_jacobi_reference run on
// the card gives the kernel's bits.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kMaxN = 128;    // float32: 128 x 129 x (4 + 8) B of shared memory
constexpr int kMaxN64 = 118;  // float64: 118 x 119 x (8 + 8) B (<= 227 KB)
constexpr int kMaxWarps = 16;
constexpr int kMaxDevices = 64;

template <typename T>
constexpr int max_order() {
  return sizeof(T) == 8 ? kMaxN64 : kMaxN;
}

__host__ __device__ inline int even_order(int n) { return n + (n & 1); }

// dynamic shared memory of one CTA: A (in T) and V (in double), m x (m + 1)
// each (an odd row stride, so that a column walk of a warp spreads over the
// banks; m (m + 1) is even, so V starts 8-byte aligned), one sweep flag and
// the m ranks of the final sort
template <typename T>
__host__ __device__ inline size_t shared_bytes(int n) {
  const int m = even_order(n);
  return (sizeof(T) + sizeof(double)) * (size_t)m * (m + 1) + sizeof(int) * (1 + (size_t)m);
}

__host__ __device__ inline int warps_for(int n) {
  const int half = even_order(n) / 2;
  return half < kMaxWarps ? half : kMaxWarps;
}

template <typename T>
__device__ inline bool rank_before(T dj, int j, T di, int i) {
  const bool nan_i = isnan(di), nan_j = isnan(dj);
  const bool lt = nan_i ? !nan_j : (dj < di);
  const bool eq = (nan_i && nan_j) || dj == di;
  return lt || (eq && j < i);
}

// pair k of step r of the circle pairing, p < q
__device__ inline void pair_of(int k, int r, int m, int* p, int* q) {
  int i, j;
  if (k == 0) {
    i = r;
    j = m - 1;
  } else {
    i = (r + k) % (m - 1);
    j = (r - k + (m - 1)) % (m - 1);
  }
  *p = min(i, j);
  *q = max(i, j);
}

// the pairs of a step are dealt to the warps round-robin (pair k to warp
// k mod W): a warp computes its pairs' rotations itself (one lane each,
// broadcast by shuffles), applies them to rows, and after a barrier to
// columns, so a step takes two barriers
constexpr int kPairsPerWarp = (kMaxN / 2 + kMaxWarps - 1) / kMaxWarps;

template <typename T>
__global__ void __launch_bounds__(kMaxWarps * 32)
jacobi_eigh_kernel(const T* __restrict__ a_in, T* __restrict__ vals_out,
                   T* __restrict__ vecs_out, int* __restrict__ sweeps_out, int n, double tol,
                   int max_sweeps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m = even_order(n);
  const int ld = m + 1;
  const int half = m / 2;
  T* A = reinterpret_cast<T*>(smem_raw);
  double* V = reinterpret_cast<double*>(A + m * ld);
  int* swept = reinterpret_cast<int*>(V + m * ld);  // a rotation ran this sweep
  int* ranks = swept + 1;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = nt >> 5;
  const size_t base = (size_t)blockIdx.x * n * n;
  const T* a = a_in + base;

  for (int idx = tid; idx < m * m; idx += nt) {
    const int i = idx / m, j = idx - (idx / m) * m;
    T x = T(0);
    if (i < n && j < n) x = (i >= j) ? a[i * n + j] : a[j * n + i];
    A[i * ld + j] = x;
    V[i * ld + j] = (i == j) ? 1.0 : 0.0;
  }

  int sweep = 0;
  while (sweep < max_sweeps) {
    if (tid == 0) *swept = 0;
    __syncthreads();  // also: the load, or the last sweep's columns, are done
    ++sweep;
    for (int r = 0; r < m - 1; ++r) {
      // this warp's rotations: lane j computes pair warp + j W
      double c_l = 1.0, s_l = 0.0, app = 0.0, aqq = 0.0;
      int p_l = 0, q_l = 0, rot_l = 0;
      const int k_l = warp + lane * n_warps;
      if (lane < kPairsPerWarp && k_l < half) {
        pair_of(k_l, r, m, &p_l, &q_l);
        app = (double)A[p_l * ld + p_l];
        aqq = (double)A[q_l * ld + q_l];
        const double apq = (double)A[p_l * ld + q_l];
        if (q_l < n && fabs(apq) > tol * sqrt(fabs(app)) * sqrt(fabs(aqq))) {
          const double tau = (aqq - app) / (2.0 * apq);
          const double t = copysign(1.0, tau) / (fabs(tau) + hypot(1.0, tau));
          c_l = 1.0 / sqrt(1.0 + t * t);
          s_l = t * c_l;
          app = app - t * apq;
          aqq = aqq + t * apq;
          rot_l = 1;
          *swept = 1;  // every writer stores the same value
        }
      }
      // rows: A <- J^T A
      for (int j = 0; j < kPairsPerWarp; ++j) {
        const int rot = __shfl_sync(0xffffffffu, rot_l, j);
        if (!rot) continue;
        const int p = __shfl_sync(0xffffffffu, p_l, j), q = __shfl_sync(0xffffffffu, q_l, j);
        const double c = __shfl_sync(0xffffffffu, c_l, j), s = __shfl_sync(0xffffffffu, s_l, j);
        for (int col = lane; col < n; col += 32) {
          const double x = (double)A[p * ld + col], y = (double)A[q * ld + col];
          A[p * ld + col] = (T)(c * x - s * y);
          A[q * ld + col] = (T)(s * x + c * y);
        }
      }
      __syncthreads();
      // columns: A <- A J (the pair's own 2x2 block set exactly), V <- V J
      for (int j = 0; j < kPairsPerWarp; ++j) {
        const int rot = __shfl_sync(0xffffffffu, rot_l, j);
        if (!rot) continue;
        const int p = __shfl_sync(0xffffffffu, p_l, j), q = __shfl_sync(0xffffffffu, q_l, j);
        const double c = __shfl_sync(0xffffffffu, c_l, j), s = __shfl_sync(0xffffffffu, s_l, j);
        const double dp = __shfl_sync(0xffffffffu, app, j);
        const double dq = __shfl_sync(0xffffffffu, aqq, j);
        for (int row = lane; row < n; row += 32) {
          if (row == p) {
            A[p * ld + p] = (T)dp;
            A[p * ld + q] = T(0);
          } else if (row == q) {
            A[q * ld + p] = T(0);
            A[q * ld + q] = (T)dq;
          } else {
            const double x = (double)A[row * ld + p], y = (double)A[row * ld + q];
            A[row * ld + p] = (T)(c * x - s * y);
            A[row * ld + q] = (T)(s * x + c * y);
          }
          const double vx = V[row * ld + p], vy = V[row * ld + q];
          V[row * ld + p] = c * vx - s * vy;
          V[row * ld + q] = s * vx + c * vy;
        }
      }
      __syncthreads();
    }
    const int again = *swept;
    __syncthreads();  // every thread has read the flag before it is reset
    if (!again) break;
  }

  // ascending order of the eigenvalues, ties by index
  for (int i = tid; i < n; i += nt) {
    const T di = A[i * ld + i];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += rank_before(A[j * ld + j], j, di, i) ? 1 : 0;
    ranks[i] = rank;
  }
  __syncthreads();
  T* vals = vals_out + (size_t)blockIdx.x * n;
  T* vecs = vecs_out + base;
  for (int i = tid; i < n; i += nt) vals[ranks[i]] = A[i * ld + i];
  // column-major, as LAPACK (and torch.linalg.eigh) returns them
  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n, row = idx - (idx / n) * n;
    vecs[ranks[i] * n + row] = (T)V[row * ld + i];
  }
  if (sweeps_out != nullptr && tid == 0) sweeps_out[blockIdx.x] = sweep;
}

bool g_attr_set[2][kMaxDevices] = {};

template <typename T>
int launch(const void* a, void* vals, void* vecs, void* sweeps, int batch, int n, double tol,
           int max_sweeps, void* stream) {
  if (n < 1 || n > max_order<T>() || batch < 1 || max_sweeps < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  bool& attr_set = g_attr_set[sizeof(T) == 8][dev];
  if (!attr_set) {
    err = cudaFuncSetAttribute(jacobi_eigh_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shared_bytes<T>(max_order<T>()));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  jacobi_eigh_kernel<T><<<batch, warps_for(n) * 32, shared_bytes<T>(n),
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(vals), static_cast<T*>(vecs),
      static_cast<int*>(sweeps), n, tol, max_sweeps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lio_eigh_max_n_f32(void) { return kMaxN; }
int lio_eigh_max_n_f64(void) { return kMaxN64; }

// vals (batch, n) and vecs (batch, n, n) column-major (the j-th eigenvector
// at vecs + j n), in the type of a (batch, n, n) row-major, only its lower
// triangle read; tol the rotation threshold (ops/eigh.py::tolerance); sweeps (batch,) int32, the sweeps each matrix ran (may be
// null). Returns the launch's cudaError_t (0: enqueued).
int lio_eigh_f32(const void* a, void* vals, void* vecs, void* sweeps, int batch, int n,
                 double tol, int max_sweeps, void* stream) {
  return launch<float>(a, vals, vecs, sweeps, batch, n, tol, max_sweeps, stream);
}

int lio_eigh_f64(const void* a, void* vals, void* vecs, void* sweeps, int batch, int n,
                 double tol, int max_sweeps, void* stream) {
  return launch<double>(a, vals, vecs, sweeps, batch, n, tol, max_sweeps, stream);
}

}  // extern "C"
