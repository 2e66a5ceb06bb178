#!/usr/bin/env python3
"""Where the eigh kernel's time goes, on one GPU.

    python3 tools/eigh_profile.py [--n 111]

1. Builds a copy of ``lio_mapping_tpu_torch/csrc/eigh.cu`` with ``clock64``
   stamps between its phases (the same arithmetic otherwise) and runs it once
   on a Wishart matrix of order ``n`` (float32, seed n). Prints the SM cycles
   each phase took for two threads: the first worker of the last column (the
   reduction's per-column steps, the accumulation of Q, applying the QL
   chains) and thread 0 (which computes the QL chains), with the QL
   iterations, their rotations and the cycles of their shifts and chains.
2. Builds a one-thread micro-benchmark of a QL chain of 110 rotations on a
   fixed tridiagonal and prints its cycles per rotation for the kernel's
   rotation (sqrt and 1/t side by side), the textbook one (sqrt, then two
   divisions), one on ``rsqrt`` and one with no square root or division
   (the recurrence's own latency), and the cycles per rotation of the
   workers' loop that applies a chain to a row of Q.

Prints one JSON object per line; the last line holds both. Exits non-zero
without CUDA. Builds go to a temporary directory.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from lio_mapping_tpu_torch.ops import cuda_build  # noqa: E402

PHASES = ["load", "sigma", "beta_tau", "p_dot", "pv_warp_sum", "barrier_1", "w", "barrier_2",
          "rank2_update", "barrier_3", "tail", "accumulate", "accumulate_wait", "ql_before",
          "ql_work", "ql_barrier", "ql_exit", "sort_out"]

# (anchor in csrc/eigh.cu, text put after it); STAMP(k) adds the cycles
# since the thread's last stamp to slot k (slots 32 + k for thread 0)
STAMPS = [
    ("  const T* a = a_in + base;\n",
     "  const bool prof_me = tid == 32 + 32 * ((n - 1) / 16) + (n - 1) % 16 || tid == 0;\n  const int prof_at = tid == 0 ? 32 : 0;\n"
     "  long long prof_t = clock64();\n"),
    ("  __syncthreads();\n\n  // Householder reduction, column by column\n", "  STAMP(0);\n"),
    ("    const double sigma = warp_sum(acc);  // every warp alike\n", "    STAMP(1);\n"),
    ("      const bool active = worker && c >= k + 1;\n", "      STAMP(2);\n"),
    ("      const double ws = warp_sum(active && half == 0 ? pc * vc : 0.0);\n", "      STAMP(3);\n"),
    ("      if (tid >= 32 && lane == 0) part[(tid >> 5) - 1] = ws;\n", "      STAMP(4);\n"),
    ("      double pv = part[0];\n", "      STAMP(5);\n"),
    ("        if (c >= k + 2) M[c * ld + k] = vc;  // the reflector, below the subdiagonal\n      }\n",
     "      STAMP(6);\n"),
    ("      if (active) {\n        const double wc = ww[c];\n", "        STAMP(7);\n"),
    ("      taus[k] = tau;\n    }\n", "    STAMP(8);\n"),
    ("  // Q = H_0 ... H_{n-3}, backward, in place\n", "  STAMP(10);\n"),
    ("      if (half == 0) M[(k + 1) * ld + c] = -tu;\n", "      STAMP(11);\n"),
    ("  int l = 0, itl = 0, iters = 0;\n", "  STAMP(12);\n"),
    ("    if (tid < 32) {\n      int lo = 0, hi = 0;\n", "      STAMP(13);\n"),
    ("      iters += more;\n", "      STAMP(14);\n      if (tid == 0) g_prof[63] += hi - lo;\n"),
    ("      const double2* cs = ring + ((t - 1) & 1) * n;\n", "      STAMP(13);\n"),
    ("        row[lo] = x;\n      }\n", "      STAMP(14);\n"),
    ("    if (h[2]) break;\n  }\n", "  STAMP(16);\n"),
    ("  if (iters_out != nullptr && tid == 0) iters_out[blockIdx.x] = iters;\n", "  STAMP(17);\n"),
    ("    __syncwarp();\n    if (lane == 0) {\n", "      const long long chain_t0 = clock64();\n"),
]
# the shift and the chain of each QL iteration, on lane 0 alone (slot 62)
STAMPS_BEFORE_CHAIN_END = ("      hi = m;\n",
                           "      g_prof[62] += clock64() - chain_t0;\n")
# stamps that must come before their anchor
STAMPS_BEFORE = [
    ("    __syncthreads();\n    if (h[2]) break;\n", "    STAMP(15);\n", 0),
    ("    __syncthreads();\n  }\n  if (tid == 0) {\n    if (n >= 2) {", "    STAMP(9);\n", 0),
]

CHAIN_SRC = r"""
#include <cuda_runtime.h>
#include <cmath>
// one thread runs a QL chain over a fixed tridiagonal, `reps` times
template <int V>
__global__ void chain(const double* d0, const double* e0, int n, int reps, long long* cyc,
                      double* sink) {
  __shared__ double d[128], e[128];
  __shared__ double2 cs[128];
  if (threadIdx.x != 0) return;
  long long total = 0;
  double acc = 0.0;
  for (int rep = 0; rep < reps; ++rep) {
    for (int i = 0; i < n; ++i) { d[i] = d0[i]; e[i] = e0[i]; }
    const long long t0 = clock64();
    double s = 1.0, c = 1.0, p = 0.0, g = d[n - 1] - d[0] + 0.3;
    double dip1 = d[n - 1], di = d[n - 2], ei = e[n - 2];
    for (int i = n - 2; i >= 0; --i) {
      const double d_nx = i > 0 ? d[i - 1] : 0.0, e_nx = i > 0 ? e[i - 1] : 0.0;
      const double f = s * ei, b = c * ei;
      const double t = f * f + g * g;
      double r, y, rinv;
      if (V == 0) { r = sqrt(t); y = 1.0 / t; rinv = r * y; }           // the kernel's
      if (V == 1) { r = sqrt(t); rinv = 1.0 / r; y = rinv * rinv; }     // textbook: sqrt, then divide
      if (V == 2) { rinv = rsqrt(t); r = t * rinv; y = rinv * rinv; }   // rsqrt
      if (V == 3) { r = t; y = 0.5 * t; rinv = t; }                      // neither
      e[i + 1] = r;
      const double gg = dip1 - p;
      const double z = ((di - gg) * f + (2.0 * b) * g) * y;
      p = f * z;
      d[i + 1] = gg + p;
      s = f * rinv;
      c = g * rinv;
      g = g * z - b;
      cs[i] = make_double2(c, s);
      dip1 = di; di = d_nx; ei = e_nx;
    }
    total += clock64() - t0;
    acc += g + cs[n / 2].x;
  }
  *cyc = total / ((long long)reps * (n - 1));
  *sink = acc;
}

// the workers' side: n threads each rotating their row of Q through a chain
__global__ void apply(int n, int reps, long long* cyc, double* sink) {
  extern __shared__ double sm[];
  const int ld = n | 1;
  double* M = sm;
  double2* cs = reinterpret_cast<double2*>(sm + ((n * ld + 1) & ~1));
  const int c = threadIdx.x;
  if (c < n) for (int j = 0; j < n; ++j) M[c * ld + j] = 1.0 / (1 + c + j);
  if (c < n) cs[c] = make_double2(0.8, 0.6);
  __syncthreads();
  const long long t0 = clock64();
  for (int rep = 0; rep < reps && c < n; ++rep) {
    double* row = M + c * ld;
    double x = row[n - 1], y = row[n - 2];
    double2 q = cs[n - 2];
    for (int i = n - 2; i >= 0; --i) {
      const int nx = i > 0 ? i - 1 : i;
      const double2 q_nx = cs[nx];
      const double y_nx = row[nx];
      row[i + 1] = q.y * y + q.x * x;
      x = q.x * y - q.y * x;
      q = q_nx;
      y = y_nx;
    }
    row[0] = x;
  }
  const long long t = clock64() - t0;
  if (c == 0) { *cyc = t / ((long long)reps * (n - 1)); *sink = M[5]; }
}

extern "C" int run_chain(int v, const double* d0, const double* e0, int n, long long* cyc,
                         double* sink) {
  void (*k[4])(const double*, const double*, int, int, long long*, double*) = {
      chain<0>, chain<1>, chain<2>, chain<3>};
  k[v]<<<1, 32>>>(d0, e0, n, 200, cyc, sink);
  return (int)cudaDeviceSynchronize();
}

extern "C" int run_apply(int n, long long* cyc, double* sink) {
  const size_t sm = ((size_t)n * (n | 1) + 2) * 8 + 16 * 128;
  cudaFuncSetAttribute(apply, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm);
  apply<<<1, 128, sm>>>(n, 200, cyc, sink);
  return (int)cudaDeviceSynchronize();
}
"""


def nvcc_so(src: str, out: str, extra=()):
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build.FLAGS, *extra, "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return ctypes.CDLL(out)


def instrumented_source() -> str:
    src = open(os.path.join(cuda_build.CSRC, "eigh.cu")).read()
    src = src.replace("namespace {\n", "__device__ long long g_prof[64];\n#define STAMP(k) do { "
                      "if (prof_me) { const long long _t = clock64(); "
                      "g_prof[prof_at + (k)] += _t - prof_t; prof_t = _t; } } while (0)\n"
                      "namespace {\n", 1)
    for anchor, text in STAMPS:
        if anchor not in src:
            raise RuntimeError(f"csrc/eigh.cu changed: no anchor {anchor!r}")
        src = src.replace(anchor, anchor + text, 1)
    anchor, text = STAMPS_BEFORE_CHAIN_END
    if anchor not in src:
        raise RuntimeError(f"csrc/eigh.cu changed: no anchor {anchor!r}")
    src = src.replace(anchor, text + anchor, 1)
    for anchor, text, at in STAMPS_BEFORE:
        if anchor not in src:
            raise RuntimeError(f"csrc/eigh.cu changed: no anchor {anchor!r}")
        lines = anchor.splitlines(keepends=True)
        src = src.replace(anchor, "".join(lines[:at + 1]) + text + "".join(lines[at + 1:]), 1)
    return src + ('\nextern "C" int prof_read(long long* out) { cudaDeviceSynchronize(); '
                  'return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(long long) * 64); }\n'
                  'extern "C" int prof_zero(void) { long long z[64] = {0}; '
                  'return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }\n')


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=111)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("eigh_profile: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    n = args.n
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "eigh_prof.cu")
        open(src, "w").write(instrumented_source())
        lib = nvcc_so(src, os.path.join(tmp, "libeighprof.so"), ("--fmad=false",))
        fn = lib.lio_eigh_f32
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
        rng = np.random.default_rng(n)
        j = rng.normal(size=(2 * n, n))
        a = torch.as_tensor(j.T @ j, dtype=torch.float32, device="cuda")
        vals = torch.empty(n, device="cuda")
        vecs = torch.empty(n, n, device="cuda")
        iters = torch.zeros(1, dtype=torch.int32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        fn(a.data_ptr(), vals.data_ptr(), vecs.data_ptr(), iters.data_ptr(), 1, n, 30, stream)
        lib.prof_zero()
        fn(a.data_ptr(), vals.data_ptr(), vecs.data_ptr(), iters.data_ptr(), 1, n, 30, stream)
        out = (ctypes.c_longlong * 64)()
        lib.prof_read(out)
        phases = {"device": smi, "n": n, "ql_iterations": int(iters.item()),
                  "ql_rotations": out[63], "ql_shift_and_chain_cycles": out[62],
                  "worker_cycles": {p: out[k] for k, p in enumerate(PHASES)},
                  "thread0_cycles": {p: out[32 + k] for k, p in enumerate(PHASES)}}
        print(json.dumps(phases), flush=True)

        chain_src = os.path.join(tmp, "chain.cu")
        open(chain_src, "w").write(CHAIN_SRC)
        clib = nvcc_so(chain_src, os.path.join(tmp, "libchain.so"), ("--fmad=false",))
        clib.run_chain.argtypes = [ci, vp, vp, ci, vp, vp]
        clib.run_apply.argtypes = [ci, vp, vp]
        m = 111
        d0 = torch.tensor([1.0 + 0.01 * ((i * 37) % 17) for i in range(m)], dtype=torch.float64,
                          device="cuda")
        e0 = torch.tensor([0.2 + 0.01 * ((i * 13) % 7) for i in range(m)], dtype=torch.float64,
                          device="cuda")
        cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
        sink = torch.zeros(1, dtype=torch.float64, device="cuda")
        chain = {}
        for v, name in enumerate(("kernel_sqrt_and_reciprocal", "sqrt_then_divide", "rsqrt",
                                  "no_sqrt_no_divide")):
            clib.run_chain(v, d0.data_ptr(), e0.data_ptr(), m, cyc.data_ptr(), sink.data_ptr())
            chain[name] = int(cyc.item())
        clib.run_apply(m, cyc.data_ptr(), sink.data_ptr())
        micro = {"device": smi, "rotations_per_chain": m - 1, "chain_cycles_per_rotation": chain,
                 "apply_cycles_per_rotation": int(cyc.item())}
        print(json.dumps(micro), flush=True)
    print(json.dumps({"profile": phases, "micro": micro}))


if __name__ == "__main__":
    main()
