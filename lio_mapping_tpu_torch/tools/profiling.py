"""Measurement helpers that know the estimator's stages and the KNN's
paths (``chip_smoke.py`` and the tools of this package).

``stage_breakdown`` times one call by the estimator step's stages, on the
host clock between ``torch.cuda.synchronize`` calls on a CUDA device.
``launches_by_path``, ``plain_searches`` and ``kernel_shapes`` attribute the
KNN searches made inside a block: the kernel's launches
(``ops/knn_kernel.LAUNCHES``) and the plain version's searches
(``ops/knn.knn_tiled``) to the functions that made them, and the kernel's
searches to their shapes. They patch module attributes for the block only.
"""

from __future__ import annotations

import contextlib
import time

import torch

from ..ops import knn as KNN
from ..ops import knn_kernel
from ..utils.timing import synchronize


def _stage_targets():
    from ..models import estimator as EST
    from ..models import pipeline as PL

    return [(PL, "process_sweep"), (EST, "predict_and_push"), (EST, "local_map"),
            (EST, "_associate_frame"), (EST, "_calculate_laser_odom"), (EST.KNN, "knn"),
            (EST.SV, "_evaluate"), (EST.SV, "solve_window"), (EST.SV, "marginalize_pivot")]


def stage_breakdown(fn, device):
    """(``fn()``, stats): wall time of one call by stage, each stage of the
    estimator step timed inclusive, synchronised before and after, with its
    call count; the whole call under ``"sweep"``. Nested stages overlap:
    ``_calculate_laser_odom`` holds its own ``_associate_frame`` and ``knn``
    calls, ``solve_window`` its ``_evaluate`` calls."""
    dev = torch.device(device)
    stats = {}

    def wrap(name, fn_):
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
    for mod, name, fn_ in originals:
        setattr(mod, name, wrap(name, fn_))
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


@contextlib.contextmanager
def launches_by_path(counts, targets, calls=None):
    """Attribute the KNN kernel's launches to the path that made them: each
    (module, function) in ``targets`` is wrapped for the block, and the
    launches made inside it are added to ``counts[name]`` (and its calls to
    ``calls[name]`` when given)."""
    originals = [(name, mod, attr, getattr(mod, attr)) for name, (mod, attr) in targets.items()]

    def wrap(name, fn):
        def run(*args, **kwargs):
            before = knn_kernel.LAUNCHES
            if calls is not None:
                calls[name] = calls.get(name, 0) + 1
            try:
                return fn(*args, **kwargs)
            finally:
                counts[name] = counts.get(name, 0) + knn_kernel.LAUNCHES - before
        return run

    for name, mod, attr, fn in originals:
        setattr(mod, attr, wrap(name, fn))
    try:
        yield counts
    finally:
        for _, mod, attr, fn in originals:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def plain_searches(counts, targets):
    """Count the plain version's searches (``ops/knn.knn_tiled``) made
    inside each (module, function) of ``targets``, into ``counts[name]``."""
    active = []
    orig_tiled = KNN.knn_tiled
    originals = [(name, mod, attr, getattr(mod, attr)) for name, (mod, attr) in targets.items()]

    def tiled(*args, **kwargs):
        for name in active:
            counts[name] = counts.get(name, 0) + 1
        return orig_tiled(*args, **kwargs)

    def wrap(name, fn):
        def run(*args, **kwargs):
            active.append(name)
            try:
                return fn(*args, **kwargs)
            finally:
                active.pop()
        return run

    KNN.knn_tiled = tiled
    for name, mod, attr, fn in originals:
        setattr(mod, attr, wrap(name, fn))
    try:
        yield counts
    finally:
        KNN.knn_tiled = orig_tiled
        for _, mod, attr, fn in originals:
            setattr(mod, attr, fn)


@contextlib.contextmanager
def kernel_shapes(shapes):
    """Count the kernel's searches by (queries, map rows, k) in ``shapes``."""
    orig = knn_kernel.knn_cuda

    def run(queries, q_mask, db, db_mask, k=5, prune_beyond=None):
        key = f"{queries.shape[0]}x{db.shape[0]}x{k}"
        shapes[key] = shapes.get(key, 0) + 1
        return orig(queries, q_mask, db, db_mask, k=k, prune_beyond=prune_beyond)

    knn_kernel.knn_cuda = run
    try:
        yield shapes
    finally:
        knn_kernel.knn_cuda = orig
