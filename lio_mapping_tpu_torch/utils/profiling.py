"""Counters and timers of the port's measurements (``chip_smoke.py`` and
``lio_mapping_tpu_torch/tools``).

Timers take the device they time: on a CUDA device the time comes from
CUDA events (``timed``, ``cuda_ms``); on the CPU from the host clock.
``device_kernel_ms``, ``count_launches`` and ``count_syncs`` read the card
(``torch.profiler``, the CUDA sync-debug mode) and take a CUDA device.
They know nothing of the estimator: the helpers that attribute time and
searches to its stages are ``tools/profiling.py``'s.

``CostCounter`` is the port's counterpart of XLA's
``compiled.cost_analysis()``: a ``TorchDispatchMode`` that records the
flops and bytes of every aten op run inside it (see its docstring).
"""

from __future__ import annotations

import time
import warnings

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .timing import synchronize


def _cuda(device, what: str) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"{what} reads the card: pass a CUDA device, got {dev}")
    return dev


def timed(fn, device, reps: int = 20, warmup: int = 3):
    """(ms, host_ms) of ``fn`` over ``reps`` back-to-back calls, after
    ``warmup`` calls: on a CUDA device CUDA events around the loop, and the
    host clock until the last call returned (what the host takes to enqueue
    one call); on the CPU the host clock for both."""
    dev = torch.device(device)
    for _ in range(warmup):
        fn()
    synchronize(dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = 1e3 * (time.perf_counter() - t0) / reps
        return ms, ms
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0) / reps
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, host_ms


def cuda_ms(fn, device, reps: int = 20) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls (``timed``)."""
    return timed(fn, device, reps)[0]


def device_kernel_ms(fn, device, reps: int = 10) -> dict:
    """Mean device time per call of each CUDA kernel ``fn`` launches
    (torch.profiler), by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    dev = _cuda(device, "device_kernel_ms")
    fn()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize(dev)
    out = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = evt.name.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0]
            out[name] = out.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3 / reps
    return out


#: the CUDA runtime and driver calls that launch one kernel, and one graph
KERNEL_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                       "cuLaunchKernelEx")
GRAPH_LAUNCH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")


def count_launches(fn, device, match=()):
    """(``fn()``, counts): launch calls (``runtime_launches``: kernels and
    CUDA graphs, also apart as ``kernel_launch_calls`` and
    ``graph_launches``), the device kernels that ran (those inside the
    graphs too), device busy time and the kernels that took most of it, for
    one call of ``fn`` (torch.profiler; its overhead inflates
    ``wall_ms``); ``matched_device_kernels``: [count, ms] of the kernels
    whose name holds each string of ``match``."""
    from torch.profiler import ProfilerActivity, profile

    dev = _cuda(device, "count_launches")
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize(dev)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    n_launch = n_graph = 0
    by_kernel = {}
    for evt in prof.events():
        if evt.name in KERNEL_LAUNCH_CALLS:
            n_launch += 1
        elif evt.name in GRAPH_LAUNCH_CALLS:
            n_graph += 1
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            rec = by_kernel.setdefault(evt.name[:80], [0, 0.0])
            rec[0] += 1
            rec[1] += evt.time_range.elapsed_us() / 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]
    matched = {m: [sum(c for name, (c, _) in by_kernel.items() if m in name),
                   sum(ms for name, (_, ms) in by_kernel.items() if m in name)] for m in match}
    return out, {"matched_device_kernels": matched, "runtime_launches": n_launch + n_graph, "kernel_launch_calls": n_launch,
                 "graph_launches": n_graph,
                 "device_kernels": sum(c for c, _ in by_kernel.values()),
                 "device_busy_ms": sum(ms for _, ms in by_kernel.values()), "wall_ms": wall_ms,
                 "top_device_kernels": [[name, c, ms] for name, (c, ms) in top]}


def count_syncs(fn, device, synchronize: bool = True):
    """(``fn()``, host syncs of the call): warnings of the CUDA sync-debug
    mode that report a synchronizing operation (not the mode's notice, once
    a process, that it is a prototype). ``synchronize``: wait for the
    call's device work after counting (a loop that counts each of its steps
    passes False, so that counting adds no sync of its own)."""
    dev = _cuda(device, "count_syncs")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    if synchronize:
        torch.cuda.synchronize(dev)
    return out, sum("called a synchronizing CUDA operation" in str(w.message) for w in caught)


class SteadySyncs:
    """Host syncs of a loop's steady steps: :meth:`step` runs one step,
    counting its syncs unless it captured a CUDA graph (a first sweep of its
    key, whose warm-up reads flags on purpose). ``clean`` is the
    ``clean_stream`` of ``cli run --stats-json`` and ``tools/bench``: at
    least one steady step and no sync in any. On a CPU device nothing is
    counted (``syncs`` stays None, ``clean`` False)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.syncs = 0 if self.device.type == "cuda" else None
        self.steps = 0

    def step(self, fn, pipe):
        if self.syncs is None:
            return fn()
        captures = pipe.graph_captures()
        out, n = count_syncs(fn, self.device, synchronize=False)
        if pipe.graph_captures() == captures:
            self.syncs += n
            self.steps += 1
        return out

    @property
    def clean(self) -> bool:
        return self.syncs == 0 and self.steps > 0


# ---------------------------------------------------------------------------
# the cost counter
# ---------------------------------------------------------------------------

#: aten ops that move or select data and compute nothing: 0 flops
_COPIES = frozenset({
    "copy", "copy_", "_to_copy", "clone", "cat", "stack", "index", "index_select", "gather",
    "scatter", "scatter_", "index_put", "index_put_", "_index_put_impl_", "index_copy",
    "index_copy_", "masked_select", "masked_fill", "masked_fill_", "fill", "fill_", "zero_",
    "_local_scalar_dense", "repeat", "flip", "roll", "constant_pad_nd", "tril", "triu",
    "_unsafe_index", "_unsafe_index_put", "set_", "resize_", "new_empty", "new_zeros",
    "new_ones", "new_full", "zeros_like", "ones_like", "full_like", "empty_like"})
#: ``torch.linalg`` (its ``linalg_*`` ops and these older names): 0 flops, as
#: XLA counts the custom calls its linear algebra lowers to
_LINALG = frozenset({
    "cholesky", "cholesky_solve", "cholesky_inverse", "_cholesky_solve_helper",
    "triangular_solve", "lu_solve", "lu_unpack", "_lu_with_info", "svd", "qr", "ormqr",
    "geqrf", "inverse", "pinverse", "det", "logdet", "slogdet", "lstsq"})


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def op_cost(func, args, kwargs, out):
    """(flops, bytes) of one aten op call: matmul-like ops by
    ``torch.utils.flop_counter``'s formulas ((m,k)x(k,n) is 2mkn, as XLA
    counts a dot); views, copies, factories, ``linalg`` and ops outside
    ``aten`` 0 flops; every other op one flop per output element. Bytes are
    the op's input plus output tensor bytes (a view moves none, an
    uninitialised factory writes none)."""
    packet = func._overloadpacket
    name = packet.__name__
    if getattr(func, "is_view", False) or name in ("detach", "alias", "lift_fresh", "_unsafe_view"):
        return 0, 0
    n_in = _tensor_bytes((args, kwargs))
    if name.startswith("empty"):
        return 0, 0
    n_bytes = n_in + _tensor_bytes(out)
    if packet in flop_registry:
        return int(flop_registry[packet](*args, **kwargs, out_val=out)), n_bytes
    if (func.namespace != "aten" or name in _COPIES or name in _LINALG or n_in == 0
            or name.startswith(("linalg_", "_linalg_"))):
        return 0, n_bytes
    n_out = sum(t.numel() for t in tree_leaves(out) if isinstance(t, torch.Tensor))
    return n_out, n_bytes


class CostCounter(TorchDispatchMode):
    """Flops and bytes of every aten op run inside the block, by the rules of
    ``op_cost``: ``flops`` and ``bytes`` are the totals, ``by_op`` maps an op's
    name to [calls, flops, bytes].

    Eager PyTorch fuses nothing, so ``bytes`` is what the ops really move
    through memory, where XLA's ``bytes accessed`` counts a fusion's inputs
    and outputs once: on the same function this count is at least XLA's.
    Work outside the dispatcher (a ctypes kernel such as the CUDA KNN) is not
    seen; its callers add it analytically, as XLA's custom calls count 0."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.by_op = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flops, n_bytes = op_cost(func, args, kwargs, out)
        self.flops += flops
        self.bytes += n_bytes
        rec = self.by_op.setdefault(str(func._overloadpacket), [0, 0, 0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += n_bytes
        return out
