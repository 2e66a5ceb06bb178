"""The estimator step replayed as CUDA graphs: the port's counterpart of the
reference's one ``jax.jit`` program per sweep (``models/pipeline.py``'s
``front_lio_body`` and ``predict`` there).

``models/estimator.step_program`` writes the step as stretches of device
work cut at the host reads that remain: each mini-GN round's exit test,
each LM iteration's ``done``, and the ``eigh`` calls (round 0's degeneracy
projection, the marginalization's two). :class:`StepGraphs` runs that
program on the card:

* a stretch is captured the first time its key comes up (an eager warm-up
  on the runner's side stream, whose results serve that sweep, then the
  capture) and replayed after that; its key names what sets its shapes and
  branches (the mini-GN round, the rounds executed, the cloud's row
  bucket), as ``jax.jit``'s cache is keyed by static arguments;
* every value that crosses from one stretch to the next lives in a static
  buffer of this runner (allocated outside the graphs' memory pool, with
  the strides and the 512-byte alignment offset of the value it holds):
  a graph copies its results into them as its last nodes, a cut's eager
  ``eigh`` writes its results there, and a decision reads its flag there.
  A name keeps its buffer from sweep to sweep (``state`` is the
  estimator's state), so a loop's stretch (one LM iteration) is one graph
  replayed;
* so no graph reads memory of another graph's pool, and the graphs replay
  one after the other on one stream: the graphs share one pool, whichever
  order the step's branches replay them in (each graph's own intermediates
  are dead once it ends);
* before a replay the runner checks that each value the stretch read at
  capture is still the same buffer (address, shape, strides); anything
  else, and any failure to capture (a host read inside a stretch), raises:
  the runner never falls back to the eager step;
* the KNN kernel's launches (and the plain version's searches) inside a
  graph are recorded at capture with the Python frames that made them and
  counted at each replay (``ops/knn_kernel.replayed``).

On the CPU the runner executes each stretch eagerly through the same
static buffers, under :class:`HostReadGuard`, which fails on any op that
would read back to the host or upload from it, and each cut with only its
own ops allowed: the CPU tests hold the step to what a capture needs.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils._python_dispatch import TorchDispatchMode

from ..ops import knn_kernel
from . import estimator as EST

#: aten ops that read a tensor back to the host or make one from host data
#: (a host sync on the card each): none may run inside a stretch
HOST_READS = frozenset({
    "_local_scalar_dense", "_linalg_check_errors", "lift_fresh", "nonzero", "masked_select",
    "bincount", "_unique2", "unique_dim", "unique_consecutive", "repeat_interleave",
    "masked_scatter"})
#: the ops of the cuts (``eigh``), which run between two graphs
CUT_OPS = frozenset({"_linalg_eigh", "linalg_eigh"})

_ALIGN = 512  # bytes: the CUDA caching allocator's block alignment


class HostReadError(RuntimeError):
    """An op that reads back to the host ran where a graph will be captured."""


class HostReadGuard(TorchDispatchMode):
    """Raises :class:`HostReadError` on any aten op named in ``forbidden``;
    ``seen`` collects the names of the ops that ran."""

    def __init__(self, forbidden, where: str = ""):
        super().__init__()
        self.forbidden = frozenset(forbidden)
        self.where = where
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._overloadpacket.__name__
        self.seen.add(name)
        if name in self.forbidden or (name in _INDEX_OPS and _bool_index(args)):
            raise HostReadError(f"aten.{name} in {self.where}: a host read where the step "
                                "is captured as a CUDA graph")
        return func(*args, **(kwargs or {}))


#: indexing ops whose bool-mask index turns into ``nonzero`` inside them
_INDEX_OPS = frozenset({"index", "index_put", "index_put_", "_index_put_impl_"})


def _bool_index(args) -> bool:
    return len(args) > 1 and any(torch.is_tensor(i) and i.dtype == torch.bool
                                 for i in (args[1] or ()))


class _Reads(dict):
    """``v`` as a stretch sees it: records the names it reads."""

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
    """What a stretch's graph depends on in a value it read: each tensor's
    address, shape, strides and type, each other leaf itself (or that the
    name is absent)."""
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


class _Graph:
    __slots__ = ("graph", "outputs", "reads", "events")

    def __init__(self, graph, outputs, reads, events):
        self.graph = graph
        self.outputs = outputs  # name -> value over static buffers
        self.reads = reads      # name -> _signature at capture
        self.events = events    # the KNN searches inside (ops/knn_kernel)


class StepGraphs:
    """Runs ``estimator.step_program`` (and the pipeline's skipped-sweep
    predict) as CUDA graphs on ``device``; see the module docstring.

    ``stats`` counts what ran: stretches, graph replays and captures,
    cuts, decisions (each a host read) and the copies made to bind inputs."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.capture = self.device.type == "cuda"
        self._graphs = {}
        self._static = {}  # (name, leaf, shape, strides, dtype) -> (base, view)
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.stream = torch.cuda.Stream(self.device) if self.capture else None
        self.stats = {"stretches": 0, "replays": 0, "captures": 0, "cuts": 0, "decisions": 0,
                      "bind_copies": 0}
        self.guard_ops = set()  # every op seen under the guard (on the CPU)

    # -- the runner protocol of estimator.step_program ----------------------
    def stretch(self, key, fn, v: dict):
        """Run one stretch: replay its graph, or capture it the first time."""
        if EST._TRUNCATE_STAGE is not None:
            raise ValueError("the graphed step does not truncate: run the pipeline with "
                             "graphs=False to use estimator._TRUNCATE_STAGE")
        self.stats["stretches"] += 1
        if not self.capture:
            reads = _Reads(v)
            with self._guarded(HOST_READS | CUT_OPS, f"stretch {key}"):
                out = fn(reads)
            v.update(self._store(out))
            return
        g = self._graphs.get(key)
        if g is None:
            self._graphs[key] = g = self._capture(key, fn, v)
            v.update(g.outputs)
            return
        for name, sig in g.reads.items():
            if _signature(v, name) != sig:
                raise RuntimeError(f"stretch {key}: input {name!r} is not the buffer its graph "
                                   "was captured with")
        g.graph.replay()
        self.stats["replays"] += 1
        knn_kernel.replayed(g.events)
        v.update(g.outputs)

    def cut(self, key, fn, v: dict):
        """Run a cut's op (an ``eigh``) eagerly, its results into static
        buffers."""
        self.stats["cuts"] += 1
        with self._guarded(HOST_READS - {"_linalg_check_errors"}, f"cut {key}"):
            out = fn(v)
        v.update(self._store(out))

    def decide(self, v: dict, name: str) -> bool:
        """A decision of the step: one host read of a device flag."""
        self.stats["decisions"] += 1
        with self._guarded(HOST_READS - {"_local_scalar_dense"}, f"decision {name}"):
            return bool(v[name])

    # -- inputs ---------------------------------------------------------------
    def bind(self, v: dict, name: str, value):
        """``v[name]`` = ``value`` in this runner's static buffers for
        ``name``: copied there unless it is there already."""
        v[name] = self._store({name: value}, count=True)[name]

    def buffer(self, name: str, shape, dtype) -> torch.Tensor:
        """A contiguous static buffer for an input staged from the host."""
        return self._static_for(name, 0, torch.empty(shape, dtype=dtype, device="meta"))

    def memory_bytes(self) -> dict:
        """Device memory of the graphs: their pool's segments, and the
        static buffers (``pool`` needs the card)."""
        static = sum(base.numel() * base.element_size() for base, _ in self._static.values())
        pool = None
        if self.capture:
            pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                       if tuple(seg.get("segment_pool_id", ())) == tuple(self.pool))
        return {"graphs": len(self._graphs), "pool": pool, "static": static}

    # -- internals ------------------------------------------------------------
    @contextlib.contextmanager
    def _guarded(self, forbidden, where):
        if self.capture:
            yield
            return
        guard = HostReadGuard(forbidden, where)
        try:
            with guard:
                yield
        finally:
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

    def _capture(self, key, fn, v: dict) -> _Graph:
        """Warm the stretch up eagerly on the side stream (its results serve
        this sweep), then capture it into a graph that writes the same
        static buffers."""
        cur = torch.cuda.current_stream(self.device)
        s = self.stream
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            outputs = self._store(fn(dict(v)))
        reads = _Reads(v)
        graph = torch.cuda.CUDAGraph()
        # capture_begin/_end as ``torch.cuda.graph`` calls them, without its
        # synchronize, gc.collect and empty_cache before each capture (the
        # last sends the next sweep's eager allocations back to cudaMalloc)
        with knn_kernel.recording(stop=StepGraphs._capture.__code__) as events, \
                torch.cuda.stream(s):
            graph.capture_begin(self.pool)
            try:
                self._store(fn(reads))
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is already invalid: report the first error
                raise
            graph.capture_end()
        cur.wait_stream(s)
        self.stats["captures"] += 1
        return _Graph(graph, outputs, {name: _signature(v, name) for name in reads.names},
                      events)
