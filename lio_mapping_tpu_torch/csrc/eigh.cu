// Batched symmetric eigendecomposition of small matrices by a float64
// Householder tridiagonalization and implicit QL: one CTA per matrix, the
// whole decision inside the kernel, nothing read back to the host. float32
// (the step's type) and float64 (the float64 pipeline of tools/debug_corner)
// in, n <= 128; the arithmetic is float64 for both and the outputs are
// rounded once to the input's type.
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
// so a step that reads nothing back needs its own kernel. The plain version
// (ops/eigh.py::eigh_plain, float64 cuSOLVER) is the same class of
// algorithm: a Householder reduction, then a tridiagonal solver. Its
// accuracy is absolute, ~n eps64 |A| (1e-14 |A|), far finer than the float32
// rounding of the step's outputs; the Schur complements' bias blocks near
// 1e12 are reduced in LAPACK dsytrd('L')'s column order, as cuSOLVER does.
//
// What bounds it: latency, not bytes or operations. A matrix is <= 132 KB
// and ~9 n^3 flops (0.0002 ms of the card at n = 111), so neither the
// tensor cores (wgmma) nor TMA is the lever; the time is the number of
// barrier-separated steps and the sequential scalar chain of each QL
// iteration. The design keeps both short:
//   * the reduction takes 3 barriers a column (a column norm every warp
//     computes itself, p = A v with two threads a column, the warp sums of
//     p.v, then the rank-2 update with two threads a column); the backward
//     accumulation of Q 1 barrier a reflector, two threads a column. Each
//     half-warp reads one row of 16 columns: no bank conflicts;
//   * QL: warp 0 finds where the tridiagonal splits (a ballot over 32
//     subdiagonals at a time), then one thread computes the iteration's
//     chain (the Wilkinson shift and the n - l Givens pairs) into a
//     double-buffered ring of (c, s) in shared memory, while each other
//     thread applies the previous iteration's whole chain to its own row
//     of Q with no barrier between rotations: one barrier a QL iteration,
//     and applying iteration t overlaps computing the chain of t + 1.
//     The chain runs with no exit test on its path; a t below 2^-960 met on
//     the way (rare) voids it, and it is run again from a copy of d and e
//     with the exit. Its rotations are the kernel's floor: ~n^2 of them at
//     ~200 cycles each (tools/eigh_profile.py), one thread's float64
//     latency, ~60% of the kernel at n = 111.
//
// Algorithm (ops/eigh.py::eigh_tridiag_reference repeats it step by step):
//   * M = the lower triangle of the input mirrored (as torch.linalg.eigh
//     reads it), in float64, times 2^-e with e from frexp of max |a_ij|
//     (clamped to [-1020, 1000]; none for a zero or non-finite maximum):
//     no square of the reduction or the chain can overflow.
//   * Column k = 0 .. n - 3: x = M[k+1:, k]; sigma = sum x[1:]^2 (lane l
//     adds rows k + 2 + l + 32 j in order, then the butterfly sum); if sigma
//     is at least the least normal number (else H = I: what is left below
//     the subdiagonal is < 2^-511, where a reflector would be built from
//     subnormal squares): beta = -copysign(sqrt(alpha^2 + sigma), alpha),
//     tau = (beta - alpha) / beta, v = (1, x[1:] / (alpha - beta)) (times
//     the reciprocal, as dlarfg scales); p = tau A22 v (a column in four
//     running sums by j % 4, two a thread, then (s0 + s1) + (s2 + s3)); K =
//     (-tau / 2) (p . v) (butterfly sums per warp, 16 columns a warp at
//     lanes 0-15, then the warps in order); w = p + K v; A22 -= v w^T + w
//     v^T (both triangles, exactly symmetric); v is stored below the
//     subdiagonal of column k. d[k] = M[k][k], e[k] = beta.
//   * Q = H_0 ... H_{n-3}, accumulated backward in place (reflector k's
//     column becomes Q's column k + 1 one step later): thread c >= k + 2
//     forms u_c = v . Q[:, c] (four running sums) and Q[:, c] -= v (tau u_c).
//   * QL (Numerical Recipes' tqli, EISPACK tql2's iteration): deflate where
//     |e_m| <= eps64 (|d_m| + |d_m+1|) or |e_m| <= 2^-480 (as LAPACK
//     dsteqr's safe minimum: far below eps64 |A| once |A| is scaled to ~1; a
//     NaN deflates); at most 30 iterations an eigenvalue; the shift g = d_m
//     - d_l + e_l / (g' + copysign(sqrt(g'^2 + 1), g')), g' = (d_l+1 - d_l)
//     / 2 e_l. A rotation, from f = s e_i, b = c e_i and t = f^2 + g^2:
//     1 / r = rsqrt(t) (CUDA's, within an ulp; torch.rsqrt on the card is
//     the same function), r = t (1 / r), y = 1 / t = (1 / r)^2; t below 2^-960
//     (f and g below 2^-480, where the first rotation cannot be: there f =
//     e_m-1) ends the chain as tqli's r = 0 does; then tqli's p = s (X s +
//     2 c b) and g = c (X s + 2 c b) - b (X = d_i - d_i+1 + p) as z = (X f +
//     2 b g) y, p = f z, g = g z - b, so that the next rotation waits on the
//     reciprocal square root only; c = g / r and s = f / r for the vectors
//     and the next f and b. No square of the chain can overflow once |A| is
//     scaled.
//   * The eigenvalues times 2^e, sorted ascending with their vectors, ties
//     by index (NaNs last): a rank per value, no atomics.
// Deterministic: each element is written by one fixed thread, no atomics.
// Built with --fmad=false (no FMA contraction; ops/eigh.py::build): every
// operation is an IEEE multiply, add, subtract, divide or square root, or
// the chain's rsqrt, so the step-by-step reference run on the card (which
// takes the rsqrt from torch.rsqrt there) gives the kernel's bits.

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kMaxN = 128;
constexpr int kThreads = 32 + 2 * kMaxN;  // the chain warp + two workers a column
constexpr int kParts = kThreads / 32;  // a float64 slot per warp
constexpr int kMaxDevices = 64;
constexpr double kEps = 0x1p-52;
constexpr double kTiny = 0x1p-960;  // f^2 + g^2 below it ends a QL chain
constexpr double kSafe = 0x1p-480;  // |e| at or below it deflates: sqrt(kTiny)
constexpr double kBig = 0x1p480;
constexpr int kBatch = 8;  // elements a thread loads before it stores any

__host__ __device__ inline int ld_of(int n) { return n | 1; }  // odd: rows spread over banks
__host__ __device__ inline int worker_warps(int n) { return (2 * n + 31) / 32; }

// dynamic shared memory of one CTA: M (n x ld), d, e, tau, v, w and QL's
// copies of d and e (n each)
// and a slot per warp, all float64; the QL ring of (c, s) (2 x n double2);
// the ring's headers (2 x 4 int) and the ranks of the sort (n int)
__host__ __device__ inline size_t ring_offset(int n) {
  const size_t doubles = (size_t)n * ld_of(n) + 7 * (size_t)n + kParts;
  return (doubles * sizeof(double) + 15) & ~(size_t)15;
}

__host__ __device__ inline size_t shared_bytes(int n) {
  return ring_offset(n) + 2 * (size_t)n * sizeof(double2) + sizeof(int) * (8 + (size_t)n);
}

__device__ __forceinline__ double warp_sum(double x) {
  // lane l adds lane l ^ off: every lane ends with the halving tree's sum
  for (int off = 16; off > 0; off >>= 1) x = x + __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool rank_before(double dj, int j, double di, int i) {
  const bool nan_i = isnan(di), nan_j = isnan(dj);
  const bool lt = nan_i ? !nan_j : (dj < di);
  const bool eq = (nan_i && nan_j) || dj == di;
  return lt || (eq && j < i);
}

// sqrt(g^2 + 1) without overflow (the shift's)
__device__ __forceinline__ double hypot1(double g) {
  const double ag = fabs(g);
  if (ag <= kBig) return sqrt(g * g + 1.0);
  const double q = 1.0 / ag;
  return ag * sqrt(1.0 + q * q);
}

// sum over j = j0 .. n - 1 of col[j * ld] * y(j) in four running sums by
// (j - j0) % 4, then (s0 + s1) + (s2 + s3), by a column's two threads
// (lanes m and m + 16 of a warp): thread h keeps s_h and s_h+2 over the
// terms j = j0 + h, j0 + h + 2, ...; every lane of the warp calls it (`on`
// false adds nothing) and gets its column's sum
template <typename Y>
__device__ __forceinline__ double half_dot(bool on, const double* col, int ld, int j0, int n,
                                           int h, Y y) {
  double sa = 0.0, sb = 0.0;  // s_h, s_h+2
  if (on) {
    int j = j0 + h;
#pragma unroll 2
    for (; j + 2 < n; j += 4) {
      sa = sa + col[j * ld] * y(j);
      sb = sb + col[(j + 2) * ld] * y(j + 2);
    }
    if (j < n) sa = sa + col[j * ld] * y(j);
  }
  const double oa = __shfl_down_sync(0xffffffffu, sa, 16);
  const double ob = __shfl_down_sync(0xffffffffu, sb, 16);
  return __shfl_sync(0xffffffffu, (sa + oa) + (sb + ob), threadIdx.x & 15);
}

// One QL iteration's shift and chain on [l, m], by one thread: writes d, e
// and (c, s) of rotation i to cs[i] for i in [lo, m). kCareful: a t below
// 2^-960 (or NaN) ends the chain there, as tqli's r = 0 does; otherwise the
// chain runs through (no exit to wait on) and returns false if it met one,
// its writes then void.
template <bool kCareful>
__device__ __forceinline__ bool ql_chain(double* d, double* e, double2* cs, int l, int m,
                                         int& lo) {
  double g = (d[l + 1] - d[l]) / (2.0 * e[l]);
  g = (d[m] - d[l]) + e[l] / (g + copysign(hypot1(g), g));
  double s = 1.0, c = 1.0, p = 0.0;
  double dip1 = d[m], di = d[m - 1], ei = e[m - 1];
  bool fine = true;
  int i = m - 1;
  for (; i >= l; --i) {
    const double d_nx = i > l ? d[i - 1] : 0.0, e_nx = i > l ? e[i - 1] : 0.0;
    const double f = s * ei, b = c * ei;
    const double t = f * f + g * g;
    const double rinv = rsqrt(t), r = t * rinv, y = rinv * rinv;
    if (kCareful) {
      if (!(t >= kTiny)) {  // f, g < 2^-480 (or NaN): r = 0, the rotations above i ran
        e[i + 1] = 0.0;
        break;
      }
    } else {
      fine &= t >= kTiny;
    }
    e[i + 1] = r;
    const double gg = dip1 - p;
    const double z = ((di - gg) * f + (2.0 * b) * g) * y;
    p = f * z;
    d[i + 1] = gg + p;
    s = f * rinv;
    c = g * rinv;
    g = g * z - b;
    cs[i] = make_double2(c, s);
    dip1 = di;
    di = d_nx;
    ei = e_nx;
  }
  lo = i + 1;
  if (i >= l) {
    d[i + 1] = d[i + 1] - p;
    e[m] = 0.0;
  } else {
    d[l] = d[l] - p;
    e[l] = g;
    e[m] = 0.0;
  }
  return fine;
}

// The next QL iteration, by warp 0: the deflation scan by ballot, a copy of
// d and e on [l, m] (db, eb), then lane 0 runs the chain through and, in
// the rare case that it met a t below 2^-960, restores the copy and runs
// it again with the exit (lo and hi are lane 0's). Returns 0 when every
// eigenvalue has converged. (l, itl) carry the current eigenvalue and its
// iterations from call to call.
__device__ int ql_next(double* d, double* e, double* db, double* eb, double2* cs, int n,
                       int max_iters, int& l, int& itl, int& lo, int& hi) {
  const int lane = threadIdx.x & 31;
  while (l < n) {
    // m: the first m >= l with a negligible e_m (n - 1 if none)
    int m = n - 1;
    for (int base = l; base < n - 1; base += 32) {
      const int i = base + lane;
      bool small = true;
      if (i < n - 1) {
        const double ae = fabs(e[i]);
        small = !(ae > kEps * (fabs(d[i]) + fabs(d[i + 1]))) || !(ae > kSafe);
      }
      const unsigned hit = __ballot_sync(0xffffffffu, small);
      if (hit) {
        m = min(n - 1, base + __ffs(hit) - 1);
        break;
      }
    }
    if (m == l || itl == max_iters) {
      ++l;
      itl = 0;
      continue;
    }
    ++itl;
    for (int i = l + lane; i <= m; i += 32) {
      db[i] = d[i];
      eb[i] = e[i];
    }
    __syncwarp();
    if (lane == 0) {
      if (!ql_chain<false>(d, e, cs, l, m, lo)) {
        for (int i = l; i <= m; ++i) {
          d[i] = db[i];
          e[i] = eb[i];
        }
        ql_chain<true>(d, e, cs, l, m, lo);
      }
      hi = m;
    }
    __syncwarp();
    return 1;
  }
  return 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tridiag_eigh_kernel(const T* __restrict__ a_in, T* __restrict__ vals_out,
                    T* __restrict__ vecs_out, int* __restrict__ iters_out, int n, int max_iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = ld_of(n);
  const int nw = worker_warps(n);
  double* M = reinterpret_cast<double*>(smem_raw);
  double* d = M + (size_t)n * ld;
  double* e = d + n;
  double* taus = e + n;
  double* vv = taus + n;
  double* ww = vv + n;
  double* db = ww + n;  // QL's copy of d and e
  double* eb = db + n;
  double* part = eb + n;
  double2* ring = reinterpret_cast<double2*>(smem_raw + ring_offset(n));
  int* hdr = reinterpret_cast<int*>(ring + 2 * n);
  int* ranks = hdr + 8;
  __shared__ double s_scale[2];

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  // a worker's column (reduction, accumulation) or row (QL, half 0): 16
  // columns a warp, lanes m and m + 16 for column 16 w + m, and its half:
  // the column's rows (or terms) half, half + 2, ...
  const int half = lane >> 4;
  const int c = ((tid - 32) >> 5) * 16 + (lane & 15);
  const bool worker = tid >= 32 && c < n;
  const size_t base = (size_t)blockIdx.x * n * n;
  const T* a = a_in + base;

  // load the lower triangle mirrored; the largest |a_ij| (a NaN wins)
  double amax = 0.0;
  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n, j = idx - (idx / n) * n;
    const double x = (double)((i >= j) ? a[i * n + j] : a[j * n + i]);
    M[i * ld + j] = x;
    const double ax = fabs(x);
    if (ax > amax || ax != ax) amax = ax;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const double o = __shfl_xor_sync(0xffffffffu, amax, off);
    if (o > amax || o != o) amax = o;
  }
  if (lane == 0) part[tid >> 5] = amax;
  __syncthreads();
  if (tid == 0) {
    double mx = 0.0;
    for (int q = 0; q < nt / 32; ++q) {
      const double o = part[q];
      if (o > mx || o != o) mx = o;
    }
    int ex = 0;
    if (mx > 0.0 && mx <= DBL_MAX) {
      frexp(mx, &ex);
      ex = min(max(ex, -1020), 1000);
    }
    s_scale[0] = ldexp(1.0, -ex);
    s_scale[1] = ldexp(1.0, ex);
  }
  __syncthreads();
  const double sc = s_scale[0];
  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n, j = idx - (idx / n) * n;
    M[i * ld + j] = M[i * ld + j] * sc;
  }
  __syncthreads();

  // Householder reduction, column by column
  for (int k = 0; k + 2 < n; ++k) {
    double acc = 0.0;
    for (int r = k + 2 + lane; r < n; r += 32) {
      const double x = M[r * ld + k];
      acc = acc + x * x;
    }
    const double sigma = warp_sum(acc);  // every warp alike
    const double alpha = M[(k + 1) * ld + k];
    double tau = 0.0, beta = alpha;
    if (sigma >= DBL_MIN) {  // else H = I: below it x[1:] is < 2^-511, far below eps64 |A|
      beta = -copysign(sqrt(alpha * alpha + sigma), alpha);
      tau = (beta - alpha) / beta;
      const double scal = 1.0 / (alpha - beta);
      const bool active = worker && c >= k + 1;
      const double vc = active ? (c == k + 1 ? 1.0 : M[c * ld + k] * scal) : 0.0;
      const double pc = tau * half_dot(active, M + c, ld, k + 1, n, half, [&](int j) {
                          return j == k + 1 ? 1.0 : M[j * ld + k] * scal;
                        });
      const double ws = warp_sum(active && half == 0 ? pc * vc : 0.0);
      if (tid >= 32 && lane == 0) part[(tid >> 5) - 1] = ws;
      __syncthreads();
      double pv = part[0];
      for (int w = 1; w < nw; ++w) pv = pv + part[w];
      if (active && half == 0) {
        vv[c] = vc;
        ww[c] = pc + ((-0.5 * tau) * pv) * vc;
        if (c >= k + 2) M[c * ld + k] = vc;  // the reflector, below the subdiagonal
      }
      __syncthreads();
      if (active) {
        const double wc = ww[c];
        // rows half, half + 2, ...: the loads of a batch, then its stores
        for (int j0 = k + 1 + half; j0 < n; j0 += 2 * kBatch) {
          double mj[kBatch], vj[kBatch], wj[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int j = min(j0 + 2 * u, n - 1);
            mj[u] = M[j * ld + c];
            vj[u] = vv[j];
            wj[u] = ww[j];
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            if (j0 + 2 * u < n) M[(j0 + 2 * u) * ld + c] = mj[u] - (vj[u] * wc + wj[u] * vc);
        }
      }
    }
    if (tid == 0) {
      d[k] = M[k * ld + k];
      e[k] = beta;
      taus[k] = tau;
    }
    __syncthreads();
  }
  if (tid == 0) {
    if (n >= 2) {
      d[n - 2] = M[(n - 2) * ld + n - 2];
      e[n - 2] = M[(n - 1) * ld + n - 2];
    }
    d[n - 1] = M[(n - 1) * ld + n - 1];
    e[n - 1] = 0.0;
    M[(n - 1) * ld + n - 1] = 1.0;
  }
  __syncthreads();

  // Q = H_0 ... H_{n-3}, backward, in place
  for (int k = n - 3; k >= 0; --k) {
    const double tk = taus[k];
    const bool right = worker && c >= k + 2;
    const double u = half_dot(right, M + c, ld, k + 2, n, half,
                              [&](int r) { return M[r * ld + k]; });
    if (right) {
      const double tu = tk * u;
      for (int r0 = k + 2 + half; r0 < n; r0 += 2 * kBatch) {
        double qr[kBatch], vr[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int r = min(r0 + 2 * j, n - 1);
          qr[j] = M[r * ld + c];
          vr[j] = M[r * ld + k];
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (r0 + 2 * j < n) M[(r0 + 2 * j) * ld + c] = qr[j] - vr[j] * tu;
      }
      if (half == 0) M[(k + 1) * ld + c] = -tu;
    } else if (worker && c == k + 1) {
      if (half == 0) M[c * ld + c] = 1.0 - tk;
      for (int r0 = k + 2 + half; r0 < n; r0 += 2 * kBatch) {
        double vr[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) vr[j] = M[min(r0 + 2 * j, n - 1) * ld + k];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (r0 + 2 * j < n) M[(r0 + 2 * j) * ld + c] = -tk * vr[j];
      }
    }
    __syncthreads();
  }
  for (int j = tid; j < n; j += nt) {
    if (j == 0) {
      M[0] = 1.0;
    } else {
      M[j] = 0.0;
      M[j * ld] = 0.0;
    }
  }
  __syncthreads();

  // implicit QL: warp 0 computes iteration t's chain while the workers
  // apply iteration t - 1's to their rows of Q
  int l = 0, itl = 0, iters = 0;
  for (int t = 0;; ++t) {
    int* h = hdr + (t & 1) * 4;
    if (tid < 32) {
      int lo = 0, hi = 0;
      const int more = ql_next(d, e, db, eb, ring + (t & 1) * n, n, max_iters, l, itl, lo, hi);
      iters += more;
      if (lane == 0) {
        h[0] = lo;
        h[1] = hi;
        h[2] = !more;
      }
    } else if (worker && half == 0 && t > 0) {
      const int* hp = hdr + ((t - 1) & 1) * 4;
      const int lo = hp[0], hi = hp[1];
      const double2* cs = ring + ((t - 1) & 1) * n;
      if (lo < hi) {
        double* row = M + c * ld;
        double x = row[hi], y = row[hi - 1];
        double2 q = cs[hi - 1];
        for (int i = hi - 1; i >= lo; --i) {
          const int nx = i > lo ? i - 1 : i;  // the next rotation's operands, ahead of the store
          const double2 q_nx = cs[nx];
          const double y_nx = row[nx];
          row[i + 1] = q.y * y + q.x * x;
          x = q.x * y - q.y * x;
          q = q_nx;
          y = y_nx;
        }
        row[lo] = x;
      }
    }
    __syncthreads();
    if (h[2]) break;
  }

  // ascending order of the eigenvalues, ties by index
  for (int i = tid; i < n; i += nt) {
    const double di = d[i];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += rank_before(d[j], j, di, i) ? 1 : 0;
    ranks[i] = rank;
  }
  __syncthreads();
  const double unsc = s_scale[1];
  T* vals = vals_out + (size_t)blockIdx.x * n;
  T* vecs = vecs_out + base;
  for (int i = tid; i < n; i += nt) vals[ranks[i]] = (T)(d[i] * unsc);
  // column-major, as LAPACK (and torch.linalg.eigh) returns them
  for (int idx = tid; idx < n * n; idx += nt) {
    const int i = idx / n, row = idx - (idx / n) * n;
    vecs[ranks[i] * n + row] = (T)M[row * ld + i];
  }
  if (iters_out != nullptr && tid == 0) iters_out[blockIdx.x] = iters;
}

bool g_attr_set[2][kMaxDevices] = {};

template <typename T>
int launch(const void* a, void* vals, void* vecs, void* iters, int batch, int n, int max_iters,
           void* stream) {
  if (n < 1 || n > kMaxN || batch < 1 || max_iters < 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  bool& attr_set = g_attr_set[sizeof(T) == 8][dev];
  if (!attr_set) {
    err = cudaFuncSetAttribute(tridiag_eigh_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)shared_bytes(kMaxN));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  tridiag_eigh_kernel<T><<<batch, 32 + 32 * worker_warps(n), shared_bytes(n),
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<T*>(vals), static_cast<T*>(vecs),
      static_cast<int*>(iters), n, max_iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lio_eigh_max_n(void) { return kMaxN; }

// vals (batch, n) and vecs (batch, n, n) column-major (the j-th eigenvector
// at vecs + j n), in the type of a (batch, n, n) row-major, only its lower
// triangle read; iters (batch,) int32, the QL iterations each matrix ran
// (may be null); max_iters: QL iterations on one eigenvalue after which it
// is taken as it stands. Returns the launch's cudaError_t (0: enqueued).
int lio_eigh_f32(const void* a, void* vals, void* vecs, void* iters, int batch, int n,
                 int max_iters, void* stream) {
  return launch<float>(a, vals, vecs, iters, batch, n, max_iters, stream);
}

int lio_eigh_f64(const void* a, void* vals, void* vecs, void* iters, int batch, int n,
                 int max_iters, void* stream) {
  return launch<double>(a, vals, vecs, iters, batch, n, max_iters, stream);
}

}  // extern "C"
