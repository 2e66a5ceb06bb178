"""Launch counts of the port's hand-written kernels, CUDA graphs included.

A wrapper calls :func:`note` where it launches its kernel (kind "kernel":
the KNN, ``ops/knn_kernel.py``; "eigh": ``ops/eigh.py``) and the KNN's
plain version where it searches (kind "plain"). While a CUDA graph is
captured (:func:`recording`) nothing runs: the launch is recorded with the
Python frames that made it, and counted at each replay of the graph
(:func:`replayed`). A launch inside a conditional node of a graph runs only
where the device decides: the graph's runner counts those on the device and
registers itself with :func:`defer`; :func:`settle` (one read of those
counters) adds them, and :func:`count` settles before it answers.

``LISTENERS`` are told of each counted launch or search as
``(kind, shape, stack)``: ``stack`` the code objects of the frames that
made it (``tools/profiling.py`` attributes launches to paths with them, and
so does the tracer while it is on: ``utils/timing.Tracer.heard``, which
``cli run --timing`` prints by path, kind and shape).
"""

from __future__ import annotations

import contextlib
import sys

#: launches (and plain searches) by kind since import or the last reset
COUNTS = {"kernel": 0, "plain": 0, "eigh": 0}
#: callables told of every counted launch as ``(kind, shape, stack)``
LISTENERS = []
_recording = None  # (events, stop) of the CUDA graph being captured
_deferred = []     # sources whose launches the device counted (``defer``)


def _stack(depth: int, stop=None):
    """The code objects of the calling frames (outermost last), from
    ``depth`` frames up to the frame running ``stop``."""
    codes = []
    f = sys._getframe(depth)
    while f is not None and f.f_code is not stop:
        codes.append(f.f_code)
        f = f.f_back
    return tuple(codes)


def note(kind: str, shape: str):
    """Count one launch of ``kind`` (or record it, while a graph is captured)."""
    if _recording is not None:
        events, stop = _recording
        events.append((kind, shape, _stack(3, stop)))
        return
    _count(kind, shape, _stack(3) if LISTENERS else ())


def _count(kind, shape, stack, times: int = 1):
    COUNTS[kind] = COUNTS.get(kind, 0) + times
    for listener in tuple(LISTENERS):
        for _ in range(times):
            listener(kind, shape, stack)


@contextlib.contextmanager
def recording(stop=None):
    """Record the launches made inside the block (a CUDA graph's capture,
    or one conditional body of it) instead of counting them; ``stop``: the
    code object of the capturing frame, where the recorded stacks end.
    Yields the list of events."""
    global _recording
    prev, events = _recording, []
    _recording = (events, stop)
    try:
        yield events
    finally:
        _recording = prev


def replayed(events, times: int = 1, outer=None):
    """Count the launches of a replayed graph ``times`` times, each with its
    frames inside the graph below the frames that replay it (``outer``, by
    default the caller's)."""
    if outer is None:
        outer = _stack(2) if LISTENERS else ()
    for kind, shape, inner in events:
        _count(kind, shape, inner + outer, times)


def outer_stack():
    """The caller's frames, as :func:`replayed` takes them by default."""
    return _stack(2) if LISTENERS else ()


def defer(source):
    """Register ``source`` (with a ``settle()`` method that counts the
    launches its device counters report since its last settle)."""
    if source not in _deferred:
        _deferred.append(source)


def settle():
    """Count every deferred launch: one read of the device counters of each
    registered source."""
    while _deferred:
        _deferred.pop(0).settle()


def count(kind: str) -> int:
    """Launches of ``kind`` so far, those decided on the device included."""
    settle()
    return COUNTS.get(kind, 0)


def reset(kind: str):
    """Start counting ``kind`` from 0 (after settling what is pending)."""
    settle()
    COUNTS[kind] = 0
