"""The program's tracer, per-stage wall-clock instrumentation and device
tracing (port of lio_mapping_tpu.utils.timing, with the tracer added).

**The tracer** (:data:`TRACER`: at most one a process, None when off, as
``ops/launches.py`` keeps its counts). :func:`enable` switches it on, and
so does building a pipeline or a 4D builder with ``LIO_TRACE=1`` in the
environment (:func:`from_env`); do that before the program is built,
since a CUDA graph captured while it is on carries its stamps and one
captured while it is off never does. When it
is off each call site costs one check: no object is built, no stamp is
captured and no ``record_function`` runs. It keeps everything in memory;
:meth:`Tracer.collect` returns the records as plain arrays.

* *Host spans* (:func:`span`): name, note, start, end, parent, the sweep's
  id (``frame_count``: every span of one sweep shares it) and the bytes a
  span staged to the card, on the host clock ``time.time_ns()``; and
  whether a ``torch.profiler`` was running (``profiled``). While
  :func:`device_trace` records (``cli run --trace-dir``), each span is also
  a ``record_function`` named ``lio.<name>``, so the spans show in its
  Chrome trace. Under any other profiler they are not: the profiler
  reports such a range on the device's timeline too, where a reader that
  sums the device's activities by launch would take it for work.
* *Device stamps* (:meth:`Tracer.stamp`): ``csrc/graph_if.cu``'s
  one-thread kernel reads the card's ``%globaltimer`` and writes
  ``(tag, ns)`` into a ring of :data:`RING_ENTRIES` on the device (the ring
  and the tag table live as long as the process, since captured graphs
  keep writing into them). A stamp captured into a graph has its tag fixed
  at capture; :func:`tag` names each one by (graph, stage, edge). A span
  opened with ``device=True`` (a call into the program) also launches a
  stamp from the host before the call's first device work, whose tag
  names the span: the call's device interval runs from it to the last
  stamp before the next call's. Nothing is read back before
  :meth:`Tracer.collect`, which reads the ring once. On the CPU a stamp
  takes the host clock.
* *One clock*: at :func:`enable` and at :meth:`Tracer.collect` the tracer
  stamps on an idle card between two host readings; the midpoint gives
  the offset, and device times are mapped to the host clock by the straight
  line through the first and the last such calibration (``drift_ppm``:
  its slope, less one). Device intervals then lie on the axis of the host
  spans and of the profiler's events.

``StageTimer`` is the reference's ``TicToc`` stopwatch per named stage (a
host span of the tracer too, when it is on). ``report`` prints what a
tracer collected: ``cli run --timing``. ``device_trace`` records a
``torch.profiler`` trace (CPU and CUDA activities) and writes it to a
directory as a Chrome trace. ``dispatch_floor_ms`` times one small program
enqueued back to back (the ``dispatch_floor_ms`` of ``cli run
--stats-json`` and ``tools/bench``).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

#: the process's tracer, or None when tracing is off
TRACER: Optional["Tracer"] = None
#: entries of the device ring of stamps (a power of two)
RING_ENTRIES = 1 << 18
#: the tag of a calibration stamp
CAL_TAG = 0

_TAGS: Dict[tuple, int] = {("", "calibration", "at"): CAL_TAG}
_TAG_LIST: List[tuple] = [("", "calibration", "at")]
_RINGS: Dict[int, tuple] = {}  # device index -> (count, tags, ns) on that card
_lib = None
_lock = threading.Lock()
_NULL = contextlib.nullcontext()
_ANNOTATE = False  # spans are record_functions (inside ``device_trace``)


def synchronize(on):
    """Wait for the card when ``on`` (a tensor or a device) is on one."""
    dev = on.device if torch.is_tensor(on) else torch.device(on)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# the tracer
# ---------------------------------------------------------------------------

def enable(device=None) -> "Tracer":
    """Switch the process's tracer on for ``device`` (the card by default)
    and return it; an existing tracer is replaced."""
    global TRACER
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    TRACER = Tracer(device)
    return TRACER


def from_env(device) -> Optional["Tracer"]:
    """The tracer, switched on for ``device`` first where it is off and
    the environment holds ``LIO_TRACE=1`` (the program's constructors call
    this)."""
    if TRACER is None and os.environ.get("LIO_TRACE") == "1":
        enable(device)
    return TRACER


def disable():
    """Switch the tracer off (graphs captured while it was on keep stamping
    into the ring; a later tracer reads only its own stamps)."""
    global TRACER
    TRACER = None


def span(name: str, note: str = "", nbytes: int = 0):
    """A host span of the tracer around the block, or nothing when it is
    off."""
    tr = TRACER
    if tr is None:
        return _NULL
    return tr.span(name, note, nbytes=nbytes)


def tag(graph: str, stage: str, edge: str = "at") -> int:
    """The tag of a stamp at ``edge`` ("start", "end" or "at", a boundary)
    of ``stage`` in the graph ``graph``."""
    key = (graph, stage, edge)
    t = _TAGS.get(key)
    if t is None:
        with _lock:
            t = _TAGS.setdefault(key, len(_TAG_LIST))
            if t == len(_TAG_LIST):
                _TAG_LIST.append(key)
    return t


def _stamp_lib():
    """``csrc/graph_if.cu``, built and loaded at first use."""
    global _lib
    with _lock:
        if _lib is None:
            from ..ops import cuda_build

            lib = ctypes.CDLL(str(cuda_build.build("graph_if.cu", "lioif")))
            vp = ctypes.c_void_p
            lib.lio_stamp.argtypes = [vp, vp, vp, vp, ctypes.c_int, ctypes.c_ulonglong]
            lib.lio_stamp.restype = ctypes.c_int
            _lib = lib
    return _lib


def _ring(index: int) -> tuple:
    """The ring of stamps on card ``index``: (count, tags, ns)."""
    with _lock:
        if index not in _RINGS:
            dev = torch.device("cuda", index)
            _RINGS[index] = (torch.zeros(1, dtype=torch.int64, device=dev),
                             torch.zeros(RING_ENTRIES, dtype=torch.int32, device=dev),
                             torch.zeros(RING_ENTRIES, dtype=torch.int64, device=dev))
    return _RINGS[index]


class _Span:
    __slots__ = ("tr", "row", "rf")

    def __init__(self, tr, row, rf):
        self.tr, self.row, self.rf = tr, row, rf

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.tr._close(self)
        return False


class Tracer:
    """Host spans and device stamps of one process on one device; see the
    module docstring."""

    def __init__(self, device):
        dev = torch.device(device)
        self.on_card = dev.type == "cuda"
        if self.on_card and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.sweep = 0   # the id of the sweep being processed
        # a span: [name, note, start, end, parent, sweep, bytes, profiled]
        self._rows: List[list] = []
        self._open: List[int] = []
        self.runners: List[dict] = []   # StepGraphs.stats["by_key"] of each runner
        self.graphs: List[tuple] = []   # (graph, body names, device counters) per capture
        self._host: List[tuple] = []    # the CPU's stamps: (tag, ns)
        self._cal: List[tuple] = []     # (host ns, device ns, bracket ns)
        if self.on_card:
            self._count, self._tags, self._ns = _ring(dev.index)
            self._ptrs = (self._count.data_ptr(), self._tags.data_ptr(), self._ns.data_ptr())
            self._stream = torch._C._cuda_getCurrentRawStream
            self._index = dev.index
            self._launch = _stamp_lib().lio_stamp
            torch.cuda.synchronize(dev)
            self.base = int(self._count.item())
        self.calibrate()

    # -- host spans -----------------------------------------------------------
    def span(self, name: str, note: str = "", sweep: int = None, device: bool = False,
             nbytes: int = 0) -> _Span:
        """Open a span (a context manager); ``sweep`` starts a sweep's id,
        ``device`` makes it a call whose device work a stamp starts."""
        i = len(self._rows)
        if sweep is not None:
            self.sweep = sweep
        rf = None
        profiled = torch._C._autograd._profiler_enabled()
        if profiled and _ANNOTATE:
            rf = torch.autograd.profiler.record_function("lio." + name)
            rf.__enter__()
        row = [name, note, time.time_ns(), 0, self._open[-1] if self._open else -1,
               self.sweep, nbytes, profiled]
        self._rows.append(row)
        self._open.append(i)
        if device:
            self.stamp(-i - 1)
        return _Span(self, row, rf)

    def _close(self, s: _Span):
        s.row[3] = time.time_ns()
        self._open.pop()
        if s.rf is not None:
            s.rf.__exit__(None, None, None)

    # -- device stamps --------------------------------------------------------
    def stamp(self, tag: int):
        """A stamp of ``tag`` on the current stream (captured, inside a
        capture); on the CPU the host clock now."""
        if not self.on_card:
            self._host.append((tag, time.time_ns()))
            return
        err = self._launch(self._stream(self._index), *self._ptrs, tag, RING_ENTRIES - 1)
        if err:
            raise RuntimeError(f"device stamp not launched: cudaError {err}")

    def calibrate(self):
        """One calibration point: of five stamps each made on an idle card
        between two host readings, the one with the narrowest bracket."""
        if not self.on_card:
            t = time.time_ns()
            self._cal.append((t, t, 0))
            return
        best = None
        for _ in range(5):
            torch.cuda.synchronize(self.device)
            h0 = time.time_ns()
            self.stamp(CAL_TAG)
            torch.cuda.synchronize(self.device)
            h1 = time.time_ns()
            if best is None or h1 - h0 < best[1] - best[0]:
                slot = (int(self._count.item()) - 1) & (RING_ENTRIES - 1)
                best = (h0, h1, int(self._ns[slot].item()))
        self._cal.append(((best[0] + best[1]) // 2, best[2], best[1] - best[0]))

    def to_host_ns(self, dev_ns: np.ndarray) -> np.ndarray:
        """Device clock -> host clock, by the line through the first and the
        last calibration."""
        (h0, d0, _), (h1, d1, _) = self._cal[0], self._cal[-1]
        slope = (h1 - h0) / (d1 - d0) if d1 != d0 else 1.0
        rel = np.round((np.asarray(dev_ns, np.int64) - d0) * slope).astype(np.int64)
        return h0 + rel

    def drift_ppm(self) -> float:
        (h0, d0, _), (h1, d1, _) = self._cal[0], self._cal[-1]
        return ((h1 - h0) / (d1 - d0) - 1.0) * 1e6 if d1 != d0 else 0.0

    # -- counters -------------------------------------------------------------
    def runner(self, by_key: dict):
        """Register a graph runner's per-key counts."""
        self.runners.append(by_key)

    def captured(self, graph: str, bodies, runs):
        """Register a captured graph's conditional bodies and their device
        counters (read by :meth:`collect`)."""
        self.graphs.append((graph, tuple(bodies), runs))

    # -- the records ----------------------------------------------------------
    def _stamps(self):
        """(tags, device ns) of this tracer's stamps in the order they ran,
        and how many the ring lost."""
        if not self.on_card:
            arr = np.asarray(self._host, np.int64).reshape(-1, 2)
            return arr[:, 0].astype(np.int32), arr[:, 1], 0
        torch.cuda.synchronize(self.device)
        n = int(self._count.item())
        kept = min(n - self.base, RING_ENTRIES)
        idx = torch.arange(n - kept, n, device=self.device) & (RING_ENTRIES - 1)
        return (self._tags[idx].cpu().numpy(), self._ns[idx].cpu().numpy(),
                n - self.base - kept)

    def collect(self) -> dict:
        """Calibrate again and return everything recorded, as plain arrays:

        * ``spans``: ``name``, ``note``, ``start_ns``, ``end_ns``,
          ``parent`` (-1: none), ``sweep``, ``bytes``, ``profiled``, and
          ``dev_start_ns`` / ``dev_end_ns`` of a call: its host-launched
          stamp and the last stamp before the next call's (-1: none);
        * ``stamps``: the graphs' stamps in the order they ran, ``tag``,
          ``ns`` on the host clock and ``span`` (the call they ran in: the
          last whose stamp ran before them; -1 before every call);
        * ``tags``: ``graph``, ``stage``, ``edge`` by tag;
        * ``graphs``: captures, replays and capture seconds per ``key``;
        * ``bodies``: each conditional body's runs (its device counter);
        * ``clock``: the calibrations (host ns, device ns, bracket ns), the
          drift, the stamps lost to the ring's overflow."""
        self.calibrate()
        tags, dev_ns, lost = self._stamps()
        host_ns = self.to_host_ns(dev_ns)
        rows = self._rows
        n = len(rows)
        dev0 = np.full(n, -1, np.int64)
        dev1 = np.full(n, -1, np.int64)
        span_of = np.full(len(tags), -1, np.int32)
        cur = -1
        for j, t in enumerate(tags.tolist()):
            if t < 0 and -t - 1 < n:
                cur = -t - 1
                dev0[cur] = host_ns[j]
            if t != CAL_TAG and cur >= 0:
                span_of[j] = cur
                dev1[cur] = host_ns[j]
        graph = tags > 0
        by_key = defaultdict(lambda: [0, 0, 0.0])
        for stats in self.runners:
            for key, c in stats.items():
                rec = by_key[key]
                rec[0] += c["captures"]
                rec[1] += c["replays"]
                rec[2] += c["capture_s"]
        keys = sorted(by_key)
        body_g, body_n, body_runs = [], [], []
        for g, names, runs in self.graphs:
            counts = runs[:len(names)].tolist() if len(names) else []
            body_g += [g] * len(names)
            body_n += list(names)
            body_runs += counts
        table = list(_TAG_LIST)
        cols = list(zip(*rows)) if rows else [()] * 8
        return {
            "spans": {"name": np.asarray(cols[0], dtype=object),
                      "note": np.asarray(cols[1], dtype=object),
                      "start_ns": np.asarray(cols[2], np.int64),
                      "end_ns": np.asarray(cols[3], np.int64),
                      "parent": np.asarray(cols[4], np.int32),
                      "sweep": np.asarray(cols[5], np.int64),
                      "bytes": np.asarray(cols[6], np.int64),
                      "profiled": np.asarray(cols[7], bool),
                      "dev_start_ns": dev0, "dev_end_ns": dev1},
            "stamps": {"tag": tags[graph], "ns": host_ns[graph], "span": span_of[graph]},
            "tags": {"graph": np.asarray([t[0] for t in table], dtype=object),
                     "stage": np.asarray([t[1] for t in table], dtype=object),
                     "edge": np.asarray([t[2] for t in table], dtype=object)},
            "graphs": {"key": np.asarray(keys, dtype=object),
                       "captures": np.asarray([by_key[k][0] for k in keys], np.int64),
                       "replays": np.asarray([by_key[k][1] for k in keys], np.int64),
                       "capture_s": np.asarray([by_key[k][2] for k in keys], np.float64)},
            "bodies": {"graph": np.asarray(body_g, dtype=object),
                       "body": np.asarray(body_n, dtype=object),
                       "runs": np.asarray(body_runs, np.int64)},
            "clock": {"calibrations": np.asarray(self._cal, np.int64).reshape(-1, 3),
                      "drift_ppm": self.drift_ppm(), "lost": int(lost),
                      "on_card": self.on_card},
        }


# ---------------------------------------------------------------------------
# reading the records
# ---------------------------------------------------------------------------

def graph_instances(rec: dict) -> List[dict]:
    """Each run of a top-level graph in the stamps: ``graph`` (its key),
    ``span`` (the call it ran in), ``start`` and ``end`` (host ns), and
    ``marks``: its stamps in order as (stage, edge, ns)."""
    tg, st = rec["tags"], rec["stamps"]
    out, cur = [], None
    for t, ns, sp in zip(st["tag"].tolist(), st["ns"].tolist(), st["span"].tolist()):
        g, stage, edge = tg["graph"][t], tg["stage"][t], tg["edge"][t]
        if stage == "graph" and edge == "start":
            cur = {"graph": g, "span": sp, "start": ns, "end": None, "marks": []}
            continue
        if cur is None or cur["graph"] != g:
            continue
        if stage == "graph":
            cur["end"] = ns
            out.append(cur)
            cur = None
        else:
            cur["marks"].append((stage, edge, ns))
    return out


def _part(stage: str, edge: str = "start") -> str:
    """A stamp's part name: a body's (a "start" or "end" edge) with its
    iteration number dropped; a boundary's is its stage."""
    head, _, it = stage.rpartition(".")
    if edge == "at" or stage == "graph" or not (head and it.isdigit()):
        return stage
    return f"{head}.<body>"


def device_parts(rec: dict) -> Dict[str, Dict[str, List[float]]]:
    """Per graph key, the device ms of each part of each run: ``graph``
    (start to end), each body (``lm.<body>``: its start to its end), and
    each stretch between two stamps (``a->b``, named by its stamps)."""
    out: Dict[str, Dict[str, List[float]]] = defaultdict(lambda: defaultdict(list))
    for inst in graph_instances(rec):
        parts = out[inst["graph"]]
        parts["graph"].append((inst["end"] - inst["start"]) / 1e6)
        marks = [("graph", "start", inst["start"])] + inst["marks"] + \
            [("graph", "end", inst["end"])]
        for (s0, e0, t0), (s1, e1, t1) in zip(marks, marks[1:]):
            if e0 == "start" and e1 == "end" and s0 == s1 and s0 != "graph":
                name = _part(s0)
            else:
                name = f"{_part(s0, e0)}->{_part(s1, e1)}"
            parts[name].append((t1 - t0) / 1e6)
    return out


def report(rec: dict) -> str:
    """What ``cli run --timing`` prints of a tracer's records: host ms per
    span (by name and note), device ms per graph part (mean over the
    graph's runs), captures and replays per key, bytes staged a sweep, and
    the clock."""
    sp = rec["spans"]
    rows = [f"{'host span':<36}{'count':>7}{'mean ms':>10}{'max ms':>10}{'total ms':>11}"]
    host = defaultdict(list)
    for name, note, a, b in zip(sp["name"], sp["note"], sp["start_ns"], sp["end_ns"]):
        host[f"{name}:{note}" if note else name].append((b - a) / 1e6)
    for name, ms in sorted(host.items(), key=lambda kv: -sum(kv[1])):
        rows.append(f"{name[:35]:<36}{len(ms):>7d}{sum(ms) / len(ms):>10.3f}"
                    f"{max(ms):>10.3f}{sum(ms):>11.1f}")
    rows.append(f"{'device (stamped)':<48}{'runs':>7}{'ms a run':>10}{'total ms':>11}")
    for key, parts in sorted(device_parts(rec).items()):
        n = len(parts["graph"])
        for part, ms in sorted(parts.items(), key=lambda kv: -sum(kv[1])):
            rows.append(f"{(key + ' ' + part)[:47]:<48}{n:>7d}{sum(ms) / n:>10.3f}"
                        f"{sum(ms):>11.1f}")
    g = rec["graphs"]
    rows.append(f"{'graph key':<48}{'captures':>9}{'replays':>9}{'capture s':>11}")
    for key, c, r, s in zip(g["key"], g["captures"], g["replays"], g["capture_s"]):
        rows.append(f"{key[:47]:<48}{c:>9d}{r:>9d}{s:>11.3f}")
    b = rec["bodies"]
    if len(b["runs"]):
        runs = defaultdict(int)
        for key, body, n in zip(b["graph"], b["body"], b["runs"]):
            runs[f"{key} {_part(body)}"] += int(n)
        rows.append("conditional bodies run (device counters): " + ", ".join(
            f"{k} {v}" for k, v in sorted(runs.items())))
    sweeps = len(set(sp["sweep"][sp["name"] == "process"].tolist()))
    staged = int(sp["bytes"][sp["name"] == "stage"].sum())
    rows.append(f"staged to the device: {staged} bytes over {sweeps} sweeps"
                + (f", {staged / sweeps:.0f} a sweep" if sweeps else ""))
    c = rec["clock"]
    rows.append(f"clock: {len(c['calibrations'])} calibrations, drift {c['drift_ppm']:.3f} ppm, "
                f"brackets {c['calibrations'][:, 2].tolist()} ns, stamps lost {c['lost']}")
    return "\n".join(rows)


# ---------------------------------------------------------------------------
# the stopwatch, the profiler trace and the dispatch floor
# ---------------------------------------------------------------------------

class StageTimer:
    """Named-stage stopwatch aggregating count / mean / max / total of host
    milliseconds; each stage is also a span of the tracer when it is on.
    Host and device overlap: a stage's time is the host's, and the device's
    is the tracer's stamps (``report``)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.records: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
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
    ``trace_dir``, the tracer's spans in it as ``lio.<name>``. Does nothing
    when ``trace_dir`` is None, so call sites pass the CLI flag straight
    through."""
    global _ANNOTATE
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    _ANNOTATE = True
    try:
        with profile(activities=acts) as prof:
            yield
    finally:
        _ANNOTATE = False
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
