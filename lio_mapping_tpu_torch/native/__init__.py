"""ctypes bindings of the native host runtime (``src/liomap_native.cc``),
the port of ``lio_mapping_tpu.native``: the ``.liol`` sequence log,
``GlobalVoxelMap`` (the host-side map archive with PCD export) and
``MeasurementQueue`` (IMU/sweep pairing).

The library is built with ``g++`` at first use, never at import, into
``lio_mapping_tpu_torch/_build/`` under a name taken from the source hash
(an edited source rebuilds). Files it writes are byte-identical to the
reference's. Unlike the reference, each log handle keeps its own last sweep
and ring channel, so logs read in turns in one thread do not mix.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent
_SRC = _DIR / "src" / "liomap_native.cc"
_BUILD = _DIR.parent / "_build"

_lib = None
_lib_lock = threading.Lock()


def build() -> Path:
    """Compile the library into ``_build/`` if needed; returns its path."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD / f"liomap_native_{digest}.so"
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           str(_SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


def _bind(l: ctypes.CDLL) -> ctypes.CDLL:
    vp, f_p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)
    u16_p, d_p = ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_double)
    sigs = {
        "lio_log_open": (vp, [ctypes.c_char_p, ctypes.c_int]),
        "lio_log_write_sweep": (ctypes.c_int, [vp, ctypes.c_double, f_p, ctypes.c_uint32]),
        "lio_log_write_sweep2": (ctypes.c_int,
                                 [vp, ctypes.c_double, f_p, u16_p, ctypes.c_uint32]),
        "lio_log_write_imu": (ctypes.c_int, [vp, ctypes.c_double, f_p, f_p]),
        "lio_log_next": (ctypes.c_int,
                         [vp, d_p, ctypes.POINTER(ctypes.c_uint32), f_p, f_p]),
        "lio_log_read_sweep_data": (ctypes.c_int, [vp, f_p, ctypes.c_uint32]),
        "lio_log_sweep_has_ring": (ctypes.c_int, [vp]),
        "lio_log_read_sweep_ring": (ctypes.c_int, [vp, u16_p, ctypes.c_uint32]),
        "lio_log_close": (None, [vp]),
        "lio_map_create": (vp, [ctypes.c_double]),
        "lio_map_insert": (None, [vp, f_p, ctypes.c_uint32]),
        "lio_map_size": (ctypes.c_uint64, [vp]),
        "lio_map_extract": (ctypes.c_uint64, [vp, f_p, ctypes.c_uint64]),
        "lio_map_save_pcd": (ctypes.c_int, [vp, ctypes.c_char_p]),
        "lio_map_free": (None, [vp]),
        "lio_mq_create": (vp, [ctypes.c_double]),
        "lio_mq_push_imu": (ctypes.c_int, [vp, ctypes.c_double, f_p, f_p]),
        "lio_mq_push_sweep": (ctypes.c_int, [vp, ctypes.c_double, ctypes.c_int64]),
        "lio_mq_next_pair": (ctypes.c_int, [vp, d_p, ctypes.POINTER(ctypes.c_int64),
                                            d_p, f_p, f_p, ctypes.c_int]),
        "lio_mq_free": (None, [vp]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(l, name)
        fn.restype = res
        fn.argtypes = args
    return l


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u16ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


class SequenceLog:
    """Binary sweep+IMU container (the rosbag replacement).

    Writers emit container v2, whose sweeps carry an optional per-point
    ring channel; v1 files read too. Iteration yields
    ("sweep", t, xyz, rel_time, ring_or_None) and ("imu", t, acc, gyr)."""

    def __init__(self, path: str, write: bool = False):
        self._l = lib()
        self._h = self._l.lio_log_open(str(path).encode(), 1 if write else 0)
        if not self._h:
            raise IOError(f"cannot open {path}")

    def write_sweep(self, t: float, xyz: np.ndarray,
                    rel_time: np.ndarray | None = None,
                    ring: np.ndarray | None = None):
        n = len(xyz)
        buf = np.zeros((n, 4), np.float32)
        buf[:, :3] = xyz
        if rel_time is not None:
            buf[:, 3] = rel_time
        if ring is None:
            self._l.lio_log_write_sweep(self._h, float(t), _fptr(buf), n)
        else:
            r = np.ascontiguousarray(ring, np.uint16)
            if len(r) != n:
                raise ValueError(f"ring has {len(r)} entries for {n} points")
            self._l.lio_log_write_sweep2(self._h, float(t), _fptr(buf), _u16ptr(r), n)

    def write_imu(self, t: float, acc: np.ndarray, gyr: np.ndarray):
        a = np.ascontiguousarray(acc, np.float32)
        g = np.ascontiguousarray(gyr, np.float32)
        self._l.lio_log_write_imu(self._h, float(t), _fptr(a), _fptr(g))

    def __iter__(self):
        while True:
            t = ctypes.c_double()
            n = ctypes.c_uint32()
            acc = np.zeros(3, np.float32)
            gyr = np.zeros(3, np.float32)
            tag = self._l.lio_log_next(self._h, ctypes.byref(t), ctypes.byref(n),
                                       _fptr(acc), _fptr(gyr))
            if tag == 0:
                return
            if tag < 0:
                raise IOError("corrupt log")
            if tag == ord("S"):
                buf = np.zeros((n.value, 4), np.float32)
                self._l.lio_log_read_sweep_data(self._h, _fptr(buf), n.value)
                ring = None
                if self._l.lio_log_sweep_has_ring(self._h):
                    ring = np.zeros(n.value, np.uint16)
                    self._l.lio_log_read_sweep_ring(self._h, _u16ptr(ring), n.value)
                yield ("sweep", t.value, buf[:, :3].copy(), buf[:, 3].copy(), ring)
            else:
                yield ("imu", t.value, acc, gyr)

    def close(self):
        if self._h:
            self._l.lio_log_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


class GlobalVoxelMap:
    """Unbounded host-side voxel-centroid map (full-map archive + export)."""

    def __init__(self, leaf: float = 0.4):
        self._l = lib()
        self._h = self._l.lio_map_create(leaf)

    def insert(self, xyz: np.ndarray):
        pts = np.ascontiguousarray(xyz, np.float32)
        self._l.lio_map_insert(self._h, _fptr(pts), len(pts))

    def __len__(self):
        return int(self._l.lio_map_size(self._h))

    def extract(self) -> np.ndarray:
        n = len(self)
        out = np.zeros((n, 3), np.float32)
        got = self._l.lio_map_extract(self._h, _fptr(out), n)
        return out[:got]

    def save_pcd(self, path: str):
        if self._l.lio_map_save_pcd(self._h, str(path).encode()) != 0:
            raise IOError(f"cannot write {path}")

    def __del__(self):
        if getattr(self, "_h", None):
            self._l.lio_map_free(self._h)
            self._h = None


class MeasurementQueue:
    """Timestamp pairing of IMU + sweeps (MeasurementManager equivalent)."""

    def __init__(self, msg_time_delay: float = 0.0, max_imu_per_pair: int = 512):
        self._l = lib()
        self._h = self._l.lio_mq_create(msg_time_delay)
        self._cap = max_imu_per_pair

    def push_imu(self, t: float, acc, gyr) -> bool:
        a = np.ascontiguousarray(acc, np.float32)
        g = np.ascontiguousarray(gyr, np.float32)
        return self._l.lio_mq_push_imu(self._h, float(t), _fptr(a), _fptr(g)) == 0

    def push_sweep(self, t: float, sweep_id: int):
        self._l.lio_mq_push_sweep(self._h, float(t), sweep_id)

    def next_pair(self):
        """Returns (sweep_t, sweep_id, imu_t (n,), acc (n,3), gyr (n,3)) or None."""
        t = ctypes.c_double()
        sid = ctypes.c_int64()
        imu_t = np.zeros(self._cap, np.float64)
        acc = np.zeros((self._cap, 3), np.float32)
        gyr = np.zeros((self._cap, 3), np.float32)
        n = self._l.lio_mq_next_pair(
            self._h, ctypes.byref(t), ctypes.byref(sid),
            imu_t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            _fptr(acc), _fptr(gyr), self._cap)
        if n < 0:
            return None
        return t.value, sid.value, imu_t[:n].copy(), acc[:n].copy(), gyr[:n].copy()

    def __del__(self):
        if getattr(self, "_h", None):
            self._l.lio_mq_free(self._h)
            self._h = None
