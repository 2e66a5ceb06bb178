"""Measurement helpers that know the estimator's stages and the KNN's
paths (``chip_smoke.py`` and the tools of this package).

``stage_breakdown`` times one call by the estimator step's stages, on the
host clock between ``torch.cuda.synchronize`` calls on a CUDA device; it
times the eager step (a pipeline made with ``graphs=False``) and raises on
a graphed one, whose stages run inside replayed CUDA graphs.
``launches_by_path``, ``plain_searches`` and ``kernel_shapes`` attribute the
KNN searches made inside a block: the kernel's launches and the plain
version's searches to the functions on whose Python stack they were made,
and the kernel's searches to their shapes (``launches_by_path`` takes
``kind="eigh"`` for the eigh kernel's launches). They listen to
``ops/launches.LISTENERS``, which also hears the launches replayed inside
the step's CUDA graphs, with the frames that made them at capture, and
settle the launches the device counted in conditional bodies as the block
ends.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import time

import torch

from ..ops import launches as LC
from ..utils.timing import synchronize


def _stage_targets():
    from ..models import estimator as EST
    from ..models import pipeline as PL

    return [(PL, "process_sweep"), (EST, "predict_and_push"), (EST, "local_map"),
            (EST, "_associate_frame"), (EST, "_gn_system"), (EST.KNN, "knn"),
            (EST.SV, "_evaluate"), (EST.SV, "lm_iteration"), (EST.SV, "marginal_system"),
            (EST.MG, "_eigh")]


def stage_breakdown(fn, device):
    """(``fn()``, stats): wall time of one call of the eager step by stage,
    each stage timed inclusive, synchronised before and after, with its call
    count; the whole call under ``"sweep"``. Nested stages overlap:
    ``_gn_system`` (a mini-GN round up to its step) holds its own
    ``_associate_frame`` and ``knn`` calls, ``lm_iteration`` its
    ``_evaluate``; ``_eigh`` is the marginalization's two eigendecompositions.
    Raises if a CUDA graph of the step replays inside the call: time a
    pipeline made with ``graphs=False``."""
    from ..models import step_graph as SG

    dev = torch.device(device)
    stats = {}

    def graphed(*args, **kwargs):
        raise ValueError("stage_breakdown times the eager step: run the pipeline with "
                         "graphs=False")

    def wrap(name, fn_):
        @functools.wraps(fn_)
        def run(*args, **kwargs):
            synchronize(dev)
            t0 = time.perf_counter()
            out = fn_(*args, **kwargs)
            synchronize(dev)
            rec = stats.setdefault(name, {"calls": 0, "ms": 0.0})
            rec["calls"] += 1
            rec["ms"] += 1e3 * (time.perf_counter() - t0)
            return out
        return run

    originals = [(mod, name, getattr(mod, name)) for mod, name in _stage_targets()]
    originals.append((SG.StepGraphs, "stretch", SG.StepGraphs.stretch))
    for mod, name, fn_ in originals[:-1]:
        setattr(mod, name, wrap(name, fn_))
    SG.StepGraphs.stretch = graphed
    try:
        synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        synchronize(dev)
        stats["sweep"] = {"calls": 1, "ms": 1e3 * (time.perf_counter() - t0)}
    finally:
        for mod, name, fn_ in originals:
            setattr(mod, name, fn_)
    return out, stats


def _codes(targets) -> dict:
    """name -> the code object of each (module, function) target."""
    return {name: inspect.unwrap(getattr(mod, attr)).__code__
            for name, (mod, attr) in targets.items()}


@contextlib.contextmanager
def _listening(kind, targets, counts):
    """Inside the block, each search of ``kind`` adds one to
    ``counts[name]`` for every target on the stack that made it."""
    codes = _codes(targets)

    def listen(kind_, shape, stack):
        if kind_ != kind:
            return
        frames = set(stack)
        for name, code in codes.items():
            if code in frames:
                counts[name] = counts.get(name, 0) + 1

    LC.LISTENERS.append(listen)
    try:
        yield counts
    finally:
        LC.settle()  # the launches the device counted in conditional bodies
        LC.LISTENERS.remove(listen)


@contextlib.contextmanager
def launches_by_path(counts, targets, calls=None, kind: str = "kernel"):
    """Attribute the KNN kernel's launches (``kind="eigh"``: the eigh
    kernel's) to the path that made them: a launch made (or, in a CUDA
    graph, captured) inside a call of the (module, function)
    ``targets[name]`` adds one to ``counts[name]``; with ``calls``, each
    call of a target adds one to ``calls[name]``."""
    originals = []
    if calls is not None:
        def wrap(name, fn):
            @functools.wraps(fn)
            def run(*args, **kwargs):
                calls[name] = calls.get(name, 0) + 1
                return fn(*args, **kwargs)
            return run

        originals = [(mod, attr, getattr(mod, attr)) for mod, attr in targets.values()]
    with _listening(kind, targets, counts):
        for name, (mod, attr) in targets.items():
            if calls is not None:
                setattr(mod, attr, wrap(name, getattr(mod, attr)))
        try:
            yield counts
        finally:
            for mod, attr, fn in originals:
                setattr(mod, attr, fn)


def plain_searches(counts, targets):
    """Count the plain version's searches (``ops/knn.knn_tiled``) made
    inside each (module, function) of ``targets``, into ``counts[name]``."""
    return _listening("plain", targets, counts)


@contextlib.contextmanager
def kernel_shapes(shapes):
    """Count the kernel's searches by (queries, map rows, k) in ``shapes``."""
    def listen(kind, shape, stack):
        if kind == "kernel":
            shapes[shape] = shapes.get(shape, 0) + 1

    LC.LISTENERS.append(listen)
    try:
        yield shapes
    finally:
        LC.settle()
        LC.LISTENERS.remove(listen)
