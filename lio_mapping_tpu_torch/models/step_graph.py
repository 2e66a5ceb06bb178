"""The per-sweep programs replayed as CUDA graphs: the port's counterpart of
the reference's one ``jax.jit`` program per sweep (``models/pipeline.py``'s
``front_odo``, ``front_lio_body``, ``predict``, ``front_map`` and
``front_assoc`` there, and the jitted ``map_builder_step``).

``models/estimator.step_program`` writes the step as stretches of device
work and conditional bodies (the mini-GN's rounds after the first, the
LM's iterations after the first: each runs where its device flag says the
loop has not stopped); ``models/odometry.odometry_program`` and
``models/mapping.mapping_program`` write the scan-to-scan and scan-to-map
GNs so, an iteration a body. :class:`StepGraphs` runs such a program on
the card as ONE graph per key, and reads nothing back:

* :meth:`StepGraphs.stretch` at the top level is a graph: captured the
  first time its key comes up (an eager warm-up on the runner's side
  stream, whose results serve that sweep, then the capture) and replayed
  after that; its key names what sets its shapes and branches (the
  cloud's row bucket, or the odometry's clouds), as ``jax.jit``'s cache is
  keyed by static arguments. A stretch inside it (the program's own) runs
  in place;
* :meth:`StepGraphs.when` is a conditional IF node (``csrc/graph_if.cu``:
  CUDA >= 12.4's conditional handles, set by a one-thread kernel from the
  device flag): the body is captured into the node's graph on the runner's
  body stream, its allocations in a pool of their own, and writes its
  results into the values made before it (``estimator.commit``), so a
  skipped body leaves them as they were. The warm-up runs every body once
  on the body stream (a body its flag skips on copies of the values, its
  results dropped), so no capture meets a first use;
* the graph's inputs and outputs live in static buffers of this runner
  (allocated outside the graphs' memory pools, with the strides and the
  512-byte alignment offset of the value they hold): a graph copies its
  results into them as its last nodes; a name keeps its buffer from sweep
  to sweep (``state`` is the estimator's state), so the graphs' pools hold
  only intermediates, dead once a graph ends, and one pair of pools serves
  every graph, whichever order they replay in;
* before a replay the runner checks that each value the program read at
  capture is still the same buffer (address, shape, strides); anything
  else, and any failure to capture (a host read inside the program),
  raises: the runner never falls back to the eager step;
* the kernels' launches inside a graph (``ops/launches.py``: the KNN's,
  the ``eigh``'s) are recorded at capture with the Python frames
  that made them and counted at each replay; those inside a conditional
  body are counted on the device (one counter a body, bumped by the body)
  and added when the counts are read (``launches.settle``);
* with the tracer on (``utils/timing.py``) a capture stamps the graph's
  start and end, each inner stretch's start (its key, as ``head``,
  ``lm.0``, ``odo.head``) and each conditional body's start and end (a
  body the device skips leaves no stamp); :meth:`StepGraphs.mark` adds a
  boundary of the program's own (the pipeline's ``front``). Each capture
  and replay is a host span with its key, and ``stats["by_key"]`` counts
  captures, replays and capture seconds per key (on the CPU a key's first
  call stands for its capture, later calls for its replays).

On the CPU the runner executes the program eagerly through the same static
buffers, under :class:`HostReadGuard`, which fails on any op that would
read back to the host or upload from it, and fails as a replay would when a
key's inputs are not the buffers of its first call; a conditional body's
flag is read outside the guard (``stats["conditionals"]``, an IF node on
the card), and
the plain ``eigh`` may check LAPACK's status only inside
``ops/eigh.eigh_plain``. The CPU tests hold the step to what a capture
needs.
"""

from __future__ import annotations

import contextlib
import ctypes
import sys
import threading
import time

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops import cuda_build
from ..ops import eigh as EIGH
from ..ops import launches as LC
from ..utils import timing as TM
from ..utils.tree import tree_map
from . import estimator as EST

#: aten ops that read a tensor back to the host or make one from host data
#: (a host sync on the card each): none may run inside a graph's program
HOST_READS = frozenset({
    "_local_scalar_dense", "_linalg_check_errors", "lift_fresh", "nonzero", "masked_select",
    "bincount", "_unique2", "unique_dim", "unique_consecutive", "repeat_interleave",
    "masked_scatter"})
#: ``torch.linalg.eigh``'s ops: the program's ``eigh`` is the port's kernel
EIGH_OPS = frozenset({"_linalg_eigh", "linalg_eigh"})
#: op -> the functions inside which the guard lets it run: the CPU's plain
#: ``eigh`` (``torch.linalg.eigh``, which checks LAPACK's status)
ALLOWED_IN = {name: (EIGH.eigh_plain.__code__,)
              for name in EIGH_OPS | {"_linalg_check_errors"}}
#: conditional bodies a graph may hold (its device counters)
MAX_BODIES = 64

_ALIGN = 512  # bytes: the CUDA caching allocator's block alignment


class HostReadError(RuntimeError):
    """An op that reads back to the host ran where a graph will be captured."""


class HostReadGuard(TorchDispatchMode):
    """Raises :class:`HostReadError` on any aten op named in ``forbidden``
    (except inside the functions ``ALLOWED_IN`` names for it); ``seen``
    collects the names of the ops that ran; :meth:`paused` lets a block
    through unchecked and unrecorded."""

    def __init__(self, forbidden, where: str = ""):
        super().__init__()
        self.forbidden = frozenset(forbidden)
        self.where = where
        self.seen = set()
        self._paused = False

    @contextlib.contextmanager
    def paused(self):
        self._paused = True
        try:
            yield
        finally:
            self._paused = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._paused:
            return func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        self.seen.add(name)
        if (name in self.forbidden and not _inside(ALLOWED_IN.get(name, ()))) or \
                (name in _INDEX_OPS and _bool_index(args)):
            raise HostReadError(f"aten.{name} in {self.where}: a host read where the step "
                                "is captured as a CUDA graph")
        return func(*args, **(kwargs or {}))


def _inside(codes) -> bool:
    """Is a function of ``codes`` on the Python stack?"""
    if not codes:
        return False
    f = sys._getframe(2)
    while f is not None:
        if f.f_code in codes:
            return True
        f = f.f_back
    return False


#: indexing ops whose bool-mask index turns into ``nonzero`` inside them
_INDEX_OPS = frozenset({"index", "index_put", "index_put_", "_index_put_impl_"})


def _bool_index(args) -> bool:
    return len(args) > 1 and any(torch.is_tensor(i) and i.dtype == torch.bool
                                 for i in (args[1] or ()))


class _Reads(dict):
    """``v`` as a program sees it: records the names it reads."""

    def __init__(self, v):
        super().__init__(v)
        self.names = set()

    def __getitem__(self, name):
        self.names.add(name)
        return super().__getitem__(name)

    def get(self, name, default=None):
        self.names.add(name)
        return super().get(name, default)

    def __contains__(self, name):
        self.names.add(name)
        return super().__contains__(name)


def _signature(v: dict, name: str):
    """What a graph depends on in a value it read: each tensor's address,
    shape, strides and type, each other leaf itself (or that the name is
    absent)."""
    if name not in v:
        return "absent"
    leaves, spec = tree_flatten(v[name])
    return spec, tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)
                       if torch.is_tensor(t) else t for t in leaves)


def _span(t: torch.Tensor) -> int:
    """Elements of storage from ``t``'s first element to its last."""
    if t.numel() == 0:
        return 0
    return 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))


def _flat(t: torch.Tensor) -> torch.Tensor:
    """``t``'s storage from its first element to its last, as a 1-D view."""
    return t.as_strided((_span(t),), (1,), t.storage_offset())


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.device != b.device or a.numel() == 0 or b.numel() == 0:
        return False
    a0, b0 = a.data_ptr(), b.data_ptr()
    return a0 < b0 + _span(b) * b.element_size() and b0 < a0 + _span(a) * a.element_size()


_if_lib = None
_if_lock = threading.Lock()


def _if_nodes():
    """``csrc/graph_if.cu``, built and loaded at first use."""
    global _if_lib
    with _if_lock:
        if _if_lib is None:
            lib = ctypes.CDLL(str(build_if_nodes()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.lio_if_begin.argtypes = [vp, vp, vp, ci]
            lib.lio_if_begin.restype = ci
            lib.lio_if_end.argtypes = [vp]
            lib.lio_if_end.restype = ci
            _if_lib = lib
    return _if_lib


def build_if_nodes():
    """Compile ``csrc/graph_if.cu`` (``ops/cuda_build.py``); its path."""
    return cuda_build.build("graph_if.cu", "lioif")


def key_name(key) -> str:
    """A graph's or a stretch's key as a name: its parts joined by dots."""
    return ".".join(str(part) for part in key)


class _Graph:
    __slots__ = ("graph", "outputs", "reads", "events", "bodies", "runs", "settled", "outer",
                 "name")

    def __init__(self, graph, outputs, reads, events, bodies, runs, name):
        self.graph = graph
        self.outputs = outputs  # name -> value over static buffers
        self.reads = reads      # name -> _signature at capture
        self.events = events    # the kernel launches outside the bodies
        self.bodies = bodies    # the launches inside each conditional body
        self.runs = runs        # (MAX_BODIES,) int64: each body's runs, on the device
        self.settled = [0] * len(bodies)
        self.outer = ()
        self.name = name        # the key as a name

    def settle(self):
        """Count the launches of the bodies that ran since the last settle
        (one read of the device counters)."""
        runs = self.runs[:len(self.bodies)].tolist()
        for i, (events, n) in enumerate(zip(self.bodies, runs)):
            if n > self.settled[i]:
                LC.replayed(events, n - self.settled[i], self.outer)
        self.settled = runs


class StepGraphs:
    """Runs the per-sweep programs (``estimator.step_program``, the
    pipelines' bootstrap and LOAM sweeps, the 4D builder's step, the
    skipped-sweep predict) as CUDA graphs on ``device``; see the module
    docstring.

    ``stats`` counts what ran: graphs (top-level stretches), replays and
    captures (on the CPU: first and later calls of a key), conditional
    bodies met (``conditionals``), host decisions (``decisions``: none on
    this runner), the flags read by the warm-up before a capture
    (``warmup_reads``), the copies made to bind inputs, and per key name
    (``by_key``) its captures, replays and capture seconds."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.capture = self.device.type == "cuda"
        self._graphs = {}
        self._seen = {}  # on the CPU: key -> {input name: its buffers' signature}
        self._static = {}  # (name, leaf, shape, strides, dtype) -> (base, view)
        if self.capture:
            self._dev = self.device.index if self.device.index is not None \
                else torch.cuda.current_device()
            self.pool = torch.cuda.graph_pool_handle()
            self.body_pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
            self.body_stream = torch.cuda.Stream(self.device)
        else:
            self.pool = self.body_pool = self.stream = self.body_stream = None
        self.stats = {"stretches": 0, "replays": 0, "captures": 0, "conditionals": 0,
                      "decisions": 0, "warmup_reads": 0, "bind_copies": 0, "by_key": {}}
        self.guard_ops = set()  # every op seen under the guard (on the CPU)
        self._mode = None   # inside a program: "cpu", "warm" or "capture"
        self._guard = None
        self._capturing = None  # (bodies, runs, names) of the graph being captured
        self._top = None    # the name of the graph whose program runs
        tr = TM.TRACER
        if tr is not None:
            tr.runner(self.stats["by_key"])

    # -- the runner protocol of estimator.step_program ----------------------
    def stretch(self, key, fn, v: dict):
        """At the top level one graph: replay it, or capture it the first
        time; inside a graph's program, run ``fn`` in place."""
        if self._mode is not None:
            self.mark(key)
            v.update(fn(v))
            return
        if EST._TRUNCATE_STAGE is not None:
            raise ValueError("the graphed step does not truncate: run the pipeline with "
                             "graphs=False to use estimator._TRUNCATE_STAGE")
        self.stats["stretches"] += 1
        if not self.capture:
            self._cpu_stretch(key, fn, v)
            return
        g = self._graphs.get(key)
        if g is None:
            name = key_name(key)
            t0 = time.perf_counter()
            self._top = name
            try:
                with TM.span("capture", name):
                    self._graphs[key] = g = self._capture(key, fn, v, name)
            finally:
                self._top = None
            self._count(name, "captures", time.perf_counter() - t0)
            v.update(g.outputs)
            return
        for name, sig in g.reads.items():
            if _signature(v, name) != sig:
                raise RuntimeError(f"graph {key}: input {name!r} is not the buffer it was "
                                   "captured with")
        with TM.span("replay", g.name):
            g.graph.replay()
        self.stats["replays"] += 1
        self._count(g.name, "replays")
        LC.replayed(g.events)
        if g.bodies:
            g.outer = LC.outer_stack()
            LC.defer(g)
        v.update(g.outputs)

    def mark(self, stage, edge: str = "at"):
        """With the tracer on, a stamp of ``stage`` (a name, or a key)
        inside the program that runs (captured with it): ``edge`` "at" a
        boundary, or a body's "start" or "end"."""
        tr = TM.TRACER
        if tr is not None and self._top is not None:
            if not isinstance(stage, str):
                stage = key_name(stage)
            tr.stamp(TM.tag(self._top, stage, edge))

    def _count(self, name: str, what: str, seconds: float = 0.0):
        rec = self.stats["by_key"].get(name)
        if rec is None:
            rec = self.stats["by_key"][name] = {"captures": 0, "replays": 0, "capture_s": 0.0}
        rec[what] += 1
        rec["capture_s"] += seconds

    def _cpu_stretch(self, key, fn, v: dict):
        """A top-level stretch on the CPU: the program run eagerly under
        the host-read guard, its inputs held to the buffers of the key's
        first call."""
        name = key_name(key)
        first = key not in self._seen
        t0 = time.perf_counter()
        with TM.span("capture" if first else "replay", name):
            reads = _Reads(v)
            self._mode, self._top = "cpu", name
            try:
                self.mark("graph", "start")
                with self._guarded(HOST_READS | EIGH_OPS, f"graph {key}"):
                    out = fn(reads)
                self._mode = None
                # what a replay on the card checks: the same input buffers
                # as the key's first call (a body skipped there read nothing)
                seen = self._seen.setdefault(key, {})
                bad = sorted(n for n in reads.names if n in seen and seen[n] != _signature(v, n))
                if bad:
                    raise RuntimeError(f"graph {key}: inputs {bad} are not the buffers of its "
                                       "first call")
                seen.update({n: _signature(v, n) for n in reads.names})
                v.update(self._store(out))
                self.mark("graph", "end")
            finally:
                self._mode = self._top = None
        if first:
            self.stats["captures"] += 1
            self._count(name, "captures", time.perf_counter() - t0)
        else:
            self.stats["replays"] += 1
            self._count(name, "replays")

    def when(self, v: dict, stop: str, key, fn):
        """A conditional body: ``fn`` runs unless the device flag ``v[stop]``
        is set, its results copied into the values it updates. On the card
        an IF node of the graph being captured; on the CPU the flag is read
        outside the guard."""
        mode = self._mode
        if mode is None:
            raise RuntimeError("a conditional body runs inside a graph's program")
        self.stats["conditionals"] += 1
        if mode == "cpu":
            with self._guard.paused():
                run = not bool(v[stop])
            if run:
                self.mark(key, "start")
                EST.commit(v, fn(v))
                self.mark(key, "end")
        elif mode == "warm":
            self._warm_body(v, stop, key, fn)
        else:
            self._capture_body(v, stop, key, fn)

    # -- inputs ---------------------------------------------------------------
    def bind(self, v: dict, name: str, value):
        """``v[name]`` = ``value`` in this runner's static buffers for
        ``name``: copied there unless it is there already."""
        v[name] = self._store({name: value}, count=True)[name]

    def buffer(self, name: str, shape, dtype) -> torch.Tensor:
        """A contiguous static buffer for an input staged from the host."""
        return self._static_for(name, 0, torch.empty(shape, dtype=dtype, device="meta"))

    def memory_bytes(self) -> dict:
        """Device memory of the graphs: their pools' segments (the bodies'
        pool apart), and the static buffers (the pools need the card)."""
        static = sum(base.numel() * base.element_size() for base, _ in self._static.values())
        pool = body_pool = None
        if self.capture:
            def size(p):
                return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                           if tuple(seg.get("segment_pool_id", ())) == tuple(p))
            pool, body_pool = size(self.pool), size(self.body_pool)
        return {"graphs": len(self._graphs), "pool": pool, "body_pool": body_pool,
                "static": static}

    # -- internals ------------------------------------------------------------
    @contextlib.contextmanager
    def _guarded(self, forbidden, where):
        guard = HostReadGuard(forbidden, where)
        self._guard = guard
        try:
            with guard:
                yield
        finally:
            self._guard = None
            self.guard_ops |= guard.seen

    def _static_for(self, name, leaf: int, t: torch.Tensor) -> torch.Tensor:
        """The static buffer of leaf ``leaf`` of ``name`` for values like
        ``t`` (same shape, type, strides and alignment offset)."""
        key = (name, leaf, tuple(t.shape), t.stride(), t.dtype)
        rec = self._static.get(key)
        if rec is None:
            size = t.element_size()
            off = 0 if t.device.type == "meta" else (t.data_ptr() % _ALIGN) // size
            base = torch.empty(off + _span(t), dtype=t.dtype, device=self.device)
            rec = (base, base.as_strided(t.shape, t.stride(), off))
            self._static[key] = rec
        return rec[1]

    def _store(self, out: dict, count: bool = False) -> dict:
        """Each tensor of ``out`` copied into its static buffer; returns
        ``out`` over the static buffers."""
        pairs, result = [], {}
        for name, value in out.items():
            leaves, spec = tree_flatten(value)
            new = []
            for i, t in enumerate(leaves):
                if not torch.is_tensor(t):
                    new.append(t)
                    continue
                dst = self._static_for(name, i, t)
                new.append(dst)
                if not (dst.data_ptr() == t.data_ptr() and dst.stride() == t.stride()):
                    pairs.append((dst, t))
            result[name] = tree_unflatten(new, spec)
        # a value that shares memory with a buffer written in this pass is
        # copied out first
        pairs = [(d, s.clone() if any(_overlap(s, d2) for d2, _ in pairs) else s)
                 for d, s in pairs]
        for dst, src in pairs:
            _flat(dst).copy_(_flat(src))
        if count:
            self.stats["bind_copies"] += len(pairs)
        return result

    def _warm_body(self, v: dict, stop: str, key, fn):
        """The warm-up's conditional body, on the body stream: run for real
        where the flag says so (one host read), on copies of the values
        otherwise, so that every body has run once before the capture."""
        self.stats["warmup_reads"] += 1
        run = not bool(v[stop])
        cur = torch.cuda.current_stream(self.device)
        b = self.body_stream
        b.wait_stream(cur)
        with torch.cuda.stream(b):
            if run:
                self.mark(key, "start")
                EST.commit(v, fn(v))
                self.mark(key, "end")
            else:
                fn(tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, dict(v)))
        cur.wait_stream(b)

    def _capture_body(self, v: dict, stop: str, key, fn):
        """Capture ``fn`` into an IF node run where ``v[stop]`` is false."""
        bodies, runs, names = self._capturing
        if len(bodies) >= MAX_BODIES:
            raise RuntimeError(f"more than {MAX_BODIES} conditional bodies in one graph")
        flag = v[stop]
        if flag.dtype != torch.bool or flag.numel() != 1 or not flag.is_cuda:
            raise ValueError(f"body {key}: {stop!r} must be one bool on {self.device}")
        lib = _if_nodes()
        cur = torch.cuda.current_stream(self.device)
        b = self.body_stream
        err = lib.lio_if_begin(cur.cuda_stream, b.cuda_stream, flag.data_ptr(), 1)
        if err != 0:
            raise RuntimeError(f"body {key}: conditional node not added: cudaError {err}")
        slot = len(bodies)
        try:
            with LC.recording(stop=StepGraphs._capture.__code__) as events, \
                    torch.cuda.stream(b):
                torch._C._cuda_beginAllocateCurrentStreamToPool(self._dev, self.body_pool)
                try:
                    self.mark(key, "start")
                    EST.commit(v, fn(v))
                    runs[slot:slot + 1].add_(1)
                    self.mark(key, "end")
                finally:
                    torch._C._cuda_endAllocateToPool(self._dev, self.body_pool)
        finally:
            err = lib.lio_if_end(b.cuda_stream)
        if err != 0:
            raise RuntimeError(f"body {key}: its capture failed: cudaError {err}")
        bodies.append(events)
        names.append(key_name(key))

    def _capture(self, key, fn, v: dict, name: str) -> _Graph:
        """Warm the program up eagerly on the side stream (its results
        serve this sweep; every conditional body runs once), then capture
        it into a graph that writes the same static buffers."""
        cur = torch.cuda.current_stream(self.device)
        s = self.stream
        s.wait_stream(cur)
        self._mode = "warm"
        try:
            with torch.cuda.stream(s):
                self.mark("graph", "start")
                outputs = self._store(fn(dict(v)))
                self.mark("graph", "end")
        finally:
            self._mode = None
        reads = _Reads(v)
        graph = torch.cuda.CUDAGraph()
        runs = torch.zeros(MAX_BODIES, dtype=torch.int64, device=self.device)
        bodies, names = [], []
        s.wait_stream(cur)
        # capture_begin/_end as ``torch.cuda.graph`` calls them, without its
        # synchronize, gc.collect and empty_cache before each capture (the
        # last sends the next sweep's eager allocations back to cudaMalloc)
        self._mode, self._capturing = "capture", (bodies, runs, names)
        try:
            with LC.recording(stop=StepGraphs._capture.__code__) as events, \
                    torch.cuda.stream(s):
                graph.capture_begin(self.pool)
                try:
                    self.mark("graph", "start")
                    self._store(fn(reads))
                    self.mark("graph", "end")
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is already invalid: report the first error
                    raise
                graph.capture_end()
        finally:
            self._mode, self._capturing = None, None
        cur.wait_stream(s)
        self.stats["captures"] += 1
        tr = TM.TRACER
        if tr is not None:
            tr.captured(name, names, runs)
        return _Graph(graph, outputs, {n: _signature(v, n) for n in reads.names},
                      events, bodies, runs, name)
