"""The port's native host runtime (``lio_mapping_tpu_torch/native``) against
the reference's (``lio_mapping_tpu/native``), on the same inputs made from
a seed: the ``.liol`` log, ``GlobalVoxelMap`` and ``MeasurementQueue``.

Files are compared byte for byte, pairs and centroids bit for bit. The
last test pins the one change against the reference: the last sweep read
lives in its log handle, so two logs read in turns in one thread keep their
own payloads (the reference keeps them in thread-local globals and returns
the other log's; it is not run on the reference).
"""

import ctypes
import struct

import numpy as np
import pytest

from lio_mapping_tpu import native as JN
from lio_mapping_tpu_torch import native as TN


@pytest.fixture(scope="module", autouse=True)
def _built():
    for mod in (JN, TN):
        try:
            mod.build()
        except Exception as e:  # pragma: no cover - toolchain missing
            pytest.skip(f"native toolchain unavailable: {e}")


def _write(mod, path, rng_seed):
    """A v2 log mixing ringless and ring sweeps and IMU messages."""
    rng = np.random.default_rng(rng_seed)
    log = mod.SequenceLog(str(path), write=True)
    for i in range(4):
        log.write_imu(0.05 * i, rng.normal(size=3), rng.normal(size=3))
        n = int(rng.integers(1, 300))
        pts = rng.normal(size=(n, 3)).astype(np.float32) * 20
        rel = rng.uniform(0, 0.1, n).astype(np.float32)
        ring = (np.arange(n) % 16).astype(np.uint16) if i % 2 else None
        log.write_sweep(0.1 * (i + 1), pts, rel if i != 2 else None, ring=ring)
    log.close()


def _items_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[0] == y[0] and x[1] == y[1]
        for u, v in zip(x[2:], y[2:]):
            if u is None or v is None:
                assert u is None and v is None
            else:
                np.testing.assert_array_equal(u, v)
                assert u.dtype == v.dtype


def test_v2_logs_are_byte_identical_and_cross_read(tmp_path):
    _write(JN, tmp_path / "ref.liol", 0)
    _write(TN, tmp_path / "port.liol", 0)
    assert (tmp_path / "ref.liol").read_bytes() == (tmp_path / "port.liol").read_bytes()
    ref_items = list(JN.SequenceLog(str(tmp_path / "port.liol")))
    port_items = list(TN.SequenceLog(str(tmp_path / "ref.liol")))
    _items_equal(port_items, ref_items)
    assert [it[0] for it in port_items] == ["imu", "sweep"] * 4
    assert [it[4] is None for it in port_items if it[0] == "sweep"] == [True, False] * 2


def test_v1_log_reads_alike(tmp_path):
    """A v1 file (no per-sweep flags byte) written by hand reads the same in
    both."""
    rng = np.random.default_rng(1)
    path = tmp_path / "v1.liol"
    with open(path, "wb") as f:
        f.write(b"LIOL" + struct.pack("<I", 1))
        for i in range(3):
            buf = rng.normal(size=(5 + i, 4)).astype(np.float32)
            f.write(b"S" + struct.pack("<d", 0.1 * i) + struct.pack("<I", len(buf)))
            f.write(buf.tobytes())
            f.write(b"I" + struct.pack("<d", 0.1 * i + 0.05))
            f.write(rng.normal(size=6).astype(np.float32).tobytes())
    port_items = list(TN.SequenceLog(str(path)))
    _items_equal(port_items, list(JN.SequenceLog(str(path))))
    assert [it[0] for it in port_items] == ["sweep", "imu"] * 3
    assert all(it[4] is None for it in port_items if it[0] == "sweep")


def test_measurement_queue_pairs_equal():
    """Out-of-order IMU (rejected), sweeps older than the IMU stream
    (dropped), and pairs that wait for an IMU sample past t + delay."""
    rng = np.random.default_rng(2)
    queues = [JN.MeasurementQueue(0.05), TN.MeasurementQueue(0.05)]
    got = [[], []]
    t_imu, t_sweep = 0.0, 0.02
    for step in range(400):
        r = rng.uniform()
        if r < 0.75:
            t_imu += 0.005
            t = t_imu - (0.02 if rng.uniform() < 0.05 else 0.0)  # some out of order
            acc, gyr = rng.normal(size=3), rng.normal(size=3)
            for q, g in zip(queues, got):
                g.append(("imu", q.push_imu(t, acc, gyr)))
        else:
            t_sweep += rng.uniform(0.0, 0.1)
            for q in queues:
                q.push_sweep(t_sweep, step)
        if rng.uniform() < 0.5:
            for q, g in zip(queues, got):
                while (pair := q.next_pair()) is not None:
                    g.append(pair)
    ref, port = got
    assert len(port) == len(ref)
    assert sum(1 for x in port if x[0] == "imu" and not x[1]) > 0  # rejections happened
    pairs = [x for x in port if x[0] != "imu"]
    assert len(pairs) > 10
    for a, b in zip(port, ref):
        if a[0] == "imu":
            assert a == b
            continue
        assert a[:2] == b[:2]
        for u, v in zip(a[2:], b[2:]):
            np.testing.assert_array_equal(u, v)


def test_global_voxel_map_extract_and_pcd_identical(tmp_path):
    rng = np.random.default_rng(3)
    maps = [JN.GlobalVoxelMap(0.4), TN.GlobalVoxelMap(0.4)]
    for _ in range(5):
        pts = (rng.normal(size=(2000, 3)) * 8).astype(np.float32)
        for m in maps:
            m.insert(pts)
    assert len(maps[0]) == len(maps[1]) > 1000
    np.testing.assert_array_equal(maps[1].extract(), maps[0].extract())
    maps[0].save_pcd(str(tmp_path / "ref.pcd"))
    maps[1].save_pcd(str(tmp_path / "port.pcd"))
    assert (tmp_path / "ref.pcd").read_bytes() == (tmp_path / "port.pcd").read_bytes()


def test_two_logs_read_in_turns_keep_their_own_sweeps(tmp_path):
    """One thread, two open logs, the C reader called in turns: next on log
    A, next on log B, then A's payload. Each handle must return its own
    points, ring flag and rings (the reference returns B's)."""
    rng = np.random.default_rng(4)
    pts_a = rng.normal(size=(32, 3)).astype(np.float32)
    pts_b = rng.normal(size=(48, 3)).astype(np.float32)
    ring_a = (np.arange(32) % 16).astype(np.uint16)
    la = TN.SequenceLog(str(tmp_path / "a.liol"), write=True)
    la.write_sweep(0.1, pts_a, None, ring=ring_a)
    la.close()
    lb = TN.SequenceLog(str(tmp_path / "b.liol"), write=True)
    lb.write_sweep(0.2, pts_b)
    lb.close()

    lib = TN.lib()
    ha = lib.lio_log_open(str(tmp_path / "a.liol").encode(), 0)
    hb = lib.lio_log_open(str(tmp_path / "b.liol").encode(), 0)
    try:
        t, n_a, n_b = ctypes.c_double(), ctypes.c_uint32(), ctypes.c_uint32()
        acc, gyr = np.zeros(3, np.float32), np.zeros(3, np.float32)
        fp = ctypes.POINTER(ctypes.c_float)
        args = (acc.ctypes.data_as(fp), gyr.ctypes.data_as(fp))
        assert lib.lio_log_next(ha, ctypes.byref(t), ctypes.byref(n_a), *args) == ord("S")
        assert lib.lio_log_next(hb, ctypes.byref(t), ctypes.byref(n_b), *args) == ord("S")
        assert (n_a.value, n_b.value) == (32, 48)

        buf = np.zeros((32, 4), np.float32)
        assert lib.lio_log_read_sweep_data(ha, buf.ctypes.data_as(fp), 32) == 0
        np.testing.assert_array_equal(buf[:, :3], pts_a)
        assert lib.lio_log_sweep_has_ring(ha) == 1
        assert lib.lio_log_sweep_has_ring(hb) == 0
        ring = np.zeros(32, np.uint16)
        assert lib.lio_log_read_sweep_ring(
            ha, ring.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), 32) == 0
        np.testing.assert_array_equal(ring, ring_a)
        buf_b = np.zeros((48, 4), np.float32)
        assert lib.lio_log_read_sweep_data(hb, buf_b.ctypes.data_as(fp), 48) == 0
        np.testing.assert_array_equal(buf_b[:, :3], pts_b)
    finally:
        lib.lio_log_close(ha)
        lib.lio_log_close(hb)

    # and through the iterators, interleaved
    items = [x for pair in zip(TN.SequenceLog(str(tmp_path / "a.liol")),
                               TN.SequenceLog(str(tmp_path / "b.liol"))) for x in pair]
    np.testing.assert_array_equal(items[0][4], ring_a)
    assert items[1][4] is None


def test_library_builds_into_the_build_directory():
    path = TN.build()
    assert path.parent.name == "_build" and path.parent.parent.name == "lio_mapping_tpu_torch"
    assert not list((TN._DIR).glob("*.so"))
