"""What a ``--trace 1`` run reads from ``torch.profiler``.

The window runs under the profiler (CPU and CUDA activities), with one
span (``record_function``) around each sweep the harness feeds
(``sweep.<kind>``), each 4D builder step (``builder.step``) and each pose
readback (``readback``). From the profiler's events, kept in memory and
never written out:

* the device's busy time: the union of every device activity (kernels,
  copies, sets) inside the window, and the window's length;
* each device activity's span: the span that holds the host call that
  launched it (the activity's CUPTI correlation id is its runtime call's;
  a CUDA graph's kernels carry its ``cudaGraphLaunch``'s);
* the ten device operations that took most time, and the ten longest
  stretches in which the device was idle, each named by the span the host
  spent most of it in (``between_sweeps`` outside every span).
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import Dict, List, Optional


SPAN_PREFIXES = ("sweep.", "builder.", "readback")
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _activity(e) -> str:
    """The event's kind: the profiler's own where it says, else guessed from
    the device and the name (older builds)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return str(kind())
    if e.device_type().name == "CPU":
        if e.is_user_annotation():
            return "user_annotation"
        return "cuda_runtime" if e.name().startswith(("cuda", "cu")) else "cpu_op"
    if e.name().startswith(SPAN_PREFIXES):
        return "gpu_user_annotation"
    return "gpu_memcpy" if e.name().startswith(("Memcpy", "Memset")) else "kernel"


def _clean(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:]", "_", name)[:64]


class Trace:
    """The reduced trace of one window; empty if the profiler saw no device
    activity."""

    def __init__(self, events, w0_ns: int, w1_ns: int):
        self.window_s = (w1_ns - w0_ns) / 1e9
        spans, runtime, dev = [], {}, []
        self.census: Dict[str, int] = defaultdict(int)
        for e in events:
            name = e.name()
            act = _activity(e)
            self.census[act] += 1
            if act == "user_annotation":
                if name.startswith(SPAN_PREFIXES):
                    spans.append((e.start_ns(), e.end_ns(), name))
            elif act in ("cuda_runtime", "cuda_driver"):
                runtime[e.correlation_id()] = e.start_ns()
            elif act in DEVICE_ACTIVITIES:
                s, d = e.start_ns(), e.duration_ns()
                if s + d <= w0_ns or s >= w1_ns:
                    continue
                dev.append((s, d, name, (e.correlation_id(), e.linked_correlation_id())))
        spans.sort()
        self.spans = spans
        starts = [s[0] for s in spans]
        self.kernels: List[tuple] = []   # (name, seconds, span index or -1)
        by_span: Dict[int, float] = defaultdict(float)
        for s, d, name, corrs in dev:
            # the runtime call that launched it: builds differ in which of
            # the two ids carries the link
            at = runtime.get(corrs[0], runtime.get(corrs[1]))
            idx = -1
            if at is not None:
                i = bisect.bisect_right(starts, at) - 1
                if i >= 0 and spans[i][0] <= at <= spans[i][1]:
                    idx = i
            self.kernels.append((name, d / 1e9, idx))
            if idx >= 0:
                by_span[idx] += d / 1e9
        self.device_s_by_span = by_span
        # busy: the union of the device intervals, clipped to the window
        iv = sorted((max(s, w0_ns), min(s + d, w1_ns)) for s, d, _, _ in dev)
        merged: List[list] = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged) / 1e9
        gaps = []
        edges = [w0_ns] + [x for ab in merged for x in ab] + [w1_ns]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((b - a, a))
        gaps.sort(reverse=True)
        self.idle_gaps = [[self._host_in(a, a + g, starts), g / 1e9] for g, a in gaps[:10]]
        self.linked = sum(1 for k in self.kernels if k[2] >= 0)
        tot: Dict[str, float] = defaultdict(float)
        for name, sec, _ in self.kernels:
            tot[name] += sec
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
        self.device_ops = [[_clean(n), s] for n, s in top]

    def _host_in(self, a: int, b: int, starts) -> str:
        """The span the host spent most of [a, b] in (``between_sweeps``
        where it spent most of it outside every span)."""
        held: Dict[str, int] = defaultdict(int)
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(self.spans) and self.spans[i][0] < b:
            s0, s1, name = self.spans[i]
            held[name] += max(0, min(s1, b) - max(s0, a))
            i += 1
        held["between_sweeps"] = (b - a) - sum(held.values())
        return max(held.items(), key=lambda kv: kv[1])[0]

    @property
    def empty(self) -> bool:
        return not self.kernels

    def span_device_ms(self, kind: str) -> List[float]:
        """Device ms of each span named ``kind``, in order."""
        return [1e3 * self.device_s_by_span.get(i, 0.0)
                for i, sp in enumerate(self.spans) if sp[2] == kind]

    def kernels_in(self, kind: str, pattern: str) -> Dict[int, List[tuple]]:
        """Per span named ``kind``: the (name, seconds) of its device
        activities whose name matches ``pattern``."""
        rx = re.compile(pattern)
        out: Dict[int, List[tuple]] = {i: [] for i, sp in enumerate(self.spans) if sp[2] == kind}
        for name, sec, idx in self.kernels:
            if idx in out and rx.search(name):
                out[idx].append((name, sec))
        return out


def breakdown(tr: Optional[Trace]) -> Optional[dict]:
    if tr is None or tr.empty:
        return None
    return {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
