"""Per-stage wall-clock instrumentation and device tracing (port of
lio_mapping_tpu.utils.timing).

``StageTimer`` is the reference's ``TicToc`` stopwatch per named stage;
with ``sync=True`` a stage given a CUDA tensor or device waits for the card
at its exit (``torch.cuda.synchronize``), so device work is charged to the
stage that launched it. ``device_trace`` records a ``torch.profiler`` trace
(CPU and CUDA activities) and writes it to a directory as a Chrome trace.
``dispatch_floor_ms`` times one small program enqueued back to back (the
``dispatch_floor_ms`` of ``cli run --stats-json`` and ``tools/bench``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch


def synchronize(on):
    """Wait for the card when ``on`` (a tensor or a device) is on one."""
    dev = on.device if torch.is_tensor(on) else torch.device(on)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class StageTimer:
    """Named-stage stopwatch aggregating count / mean / max / total.

    ``sync=True`` waits for the card at stage exit when the stage names a
    CUDA tensor or device in ``sync_on``. Leave it off for throughput
    measurement (host and device then overlap, and only end-to-end numbers
    mean anything)."""

    def __init__(self, enabled: bool = True, sync: bool = False):
        self.enabled = enabled
        self.sync = sync
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and sync_on is not None:
                synchronize(sync_on)
            self.records.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)

    def tic(self) -> float:
        return time.perf_counter()

    def toc(self, name: str, t0: float) -> float:
        """Explicit TicToc-style pair; returns elapsed ms."""
        ms = (time.perf_counter() - t0) * 1e3
        if self.enabled:
            self.records.setdefault(name, []).append(ms)
        return ms

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"count": len(vals), "mean_ms": sum(vals) / len(vals),
                       "max_ms": max(vals), "total_ms": sum(vals)}
                for name, vals in self.records.items()}

    def report(self) -> str:
        rows = [f"{'stage':<28}{'count':>7}{'mean ms':>10}{'max ms':>10}{'total ms':>11}"]
        for name, s in sorted(self.summary().items(), key=lambda kv: -kv[1]["total_ms"]):
            rows.append(f"{name:<28}{s['count']:>7d}{s['mean_ms']:>10.2f}"
                        f"{s['max_ms']:>10.2f}{s['total_ms']:>11.1f}")
        return "\n".join(rows)

    def reset(self):
        self.records.clear()


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]):
    """``torch.profiler`` over the block (CPU, and CUDA when there is a
    card), exported as ``trace.json`` (Chrome trace format) into
    ``trace_dir``. Does nothing when ``trace_dir`` is None, so call sites
    pass the CLI flag straight through."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def dispatch_floor_ms(device) -> float:
    """Mean wall time of one small program (a 64x15x15 einsum chain) enqueued
    back to back 30 times on ``device``, after 3 warm-up calls, synchronised
    before and after: on the card, the floor of eager dispatch."""
    x = torch.ones((64, 15, 15), dtype=torch.float32, device=device)

    def probe():
        return torch.einsum("kij,kjl,kml->im", x, x, x)

    for _ in range(3):
        probe()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(30):
        probe()
    synchronize(device)
    return (time.perf_counter() - t0) / 30 * 1e3
