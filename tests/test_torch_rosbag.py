"""The port's ROS bag path (``lio_mapping_tpu_torch/io/rosbag.py`` and the
``bag-info`` / ``convert-bag`` / ``export-bag`` commands) against the
reference's (``lio_mapping_tpu``), on the CPU.

* Every case of ``tests/test_rosbag.py`` run on the port: the container
  round trip (none/bz2 chunks), topics and ``detect_topics``,
  ``convert_bag`` with the ``ring`` field, ``min_range``, the relative-time
  renormalisation, the rosbag 1.x and lz4 errors, the CLI bag commands.
* Across the packages: the same messages through both ``BagWriter``s give
  the same bytes; a bag written by either reads the same in the other;
  ``convert_bag`` writes byte-identical ``.liol`` files; ``_relative_times``
  agrees on Velodyne f32 ``time``, Ouster u32-ns ``t`` and Hesai f64
  ``timestamp`` columns; the CLI prints the same lines and exports the
  same bag.
* The ring-annotated rig end to end at the small profile of
  ``tests/test_cli_e2e.py`` (30 sweeps, azimuth 300): ``convert-bag`` of a
  bag whose clouds carry only ``ring`` feeds a ``sensor.uneven`` profile to
  INITED with ATE < 0.45 m (the reference's own bound), and the same
  profile without rings raises.
* The bag round trip of a ``simulate`` log: the same points and IMU, the
  stamps moved onto ROS time's nanosecond grid (within 1e-9 s), the log
  byte-identical after a second round trip, and ``run``'s host loop
  handing the pipeline the same sweeps and IMU buffers but for the
  boundary sample that the moved stamp puts on ``t + msg_time_delay``
  itself (one extra row with dt below 1e-9 s). The float32 estimator
  amplifies that row (millimetres to centimetres of pose), so the poses
  themselves are not compared.
"""

import copy
import os
import re
import struct

import numpy as np
import pytest
import torch
import yaml

from lio_mapping_tpu import cli as JCLI
from lio_mapping_tpu import native as JN
from lio_mapping_tpu.io import rosbag as JRB
from lio_mapping_tpu_torch import cli as TCLI
from lio_mapping_tpu_torch import native as TN
from lio_mapping_tpu_torch.io import rosbag as TRB
from lio_mapping_tpu_torch.io.evaluation import load_tum

from tests.test_cli_e2e import SMALL_PROFILE

PKGS = {"ref": (JRB, JN), "port": (TRB, TN)}
N_E2E = 30  # tests/test_cli_e2e.N_SWEEPS


def _write_demo_bag(rb, path, compression="none", n_sweeps=3, imu_rate=100.0, with_time=True,
                    with_ring=True):
    """tests/test_rosbag._write_demo_bag through the given package's writer."""
    rng = np.random.default_rng(42)
    sweeps, imus = [], []
    with rb.BagWriter(path, compression=compression, chunk_size=4096) as w:
        t_imu = 100.0
        for k in range(n_sweeps):
            t0 = 100.0 + 0.1 * k
            while t_imu < t0 + 0.1:
                t_imu += 1.0 / imu_rate
                acc = np.asarray([0.1, -0.2, 9.81]) + 0.01 * rng.standard_normal(3)
                gyr = 0.02 * rng.standard_normal(3)
                imus.append((t_imu, acc, gyr))
                w.write("/imu/data", "sensor_msgs/Imu", t_imu, rb.serialize_imu(t_imu, acc, gyr))
            n = 64
            xyz = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
            xyz[5] = np.nan  # non-finite points are dropped on convert
            rel = np.linspace(0, 0.099, n).astype(np.float32) if with_time else None
            ring = (np.arange(n) % 16).astype(np.uint16) if with_ring else None
            sweeps.append((t0 + 0.1, xyz, rel))
            w.write("/velodyne_points", "sensor_msgs/PointCloud2", t0 + 0.1,
                    rb.serialize_pointcloud2(t0 + 0.1, xyz, rel, ring))
    return sweeps, imus


def _log_items(native, path):
    return list(native.SequenceLog(str(path)))


# ---------------------------------------------------------------------------
# tests/test_rosbag.py on the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_bag_roundtrip(tmp_path, compression):
    bag = str(tmp_path / "demo.bag")
    sweeps, imus = _write_demo_bag(TRB, bag, compression)
    clouds, imu_msgs = [], []
    for msg in TRB.BagReader(bag):
        if msg.msg_type == "sensor_msgs/PointCloud2":
            clouds.append(TRB.parse_pointcloud2(msg.raw))
        elif msg.msg_type == "sensor_msgs/Imu":
            imu_msgs.append(TRB.parse_imu(msg.raw))
    assert len(clouds) == len(sweeps) and len(imu_msgs) == len(imus)
    for (t, xyz, rel), cloud in zip(sweeps, clouds):
        assert abs(cloud.stamp - t) < 1e-6
        np.testing.assert_array_equal(cloud.xyz(), xyz)
        np.testing.assert_allclose(cloud.field_array("time"), rel)
        assert cloud.field_array("ring").dtype == np.uint16
    for (t, acc, gyr), imu in zip(imus, imu_msgs):
        assert abs(imu.stamp - t) < 1e-6
        np.testing.assert_allclose(imu.linear_acceleration, acc)
        np.testing.assert_allclose(imu.angular_velocity, gyr)


def test_topics_inventory(tmp_path):
    bag = str(tmp_path / "demo.bag")
    sweeps, imus = _write_demo_bag(TRB, bag)
    info = TRB.BagReader(bag).topics()
    assert info["/velodyne_points"] == ("sensor_msgs/PointCloud2", len(sweeps))
    assert info["/imu/data"] == ("sensor_msgs/Imu", len(imus))
    assert TRB.detect_topics(bag) == ("/velodyne_points", "/imu/data")


def test_convert_bag_to_sequence_log(tmp_path):
    bag, out = str(tmp_path / "demo.bag"), str(tmp_path / "seq.liol")
    sweeps, imus = _write_demo_bag(TRB, bag, compression="bz2")
    assert TRB.convert_bag(bag, out) == (len(sweeps), len(imus))
    items = _log_items(TN, out)
    got_sweeps = [x for x in items if x[0] == "sweep"]
    got_imus = [x for x in items if x[0] == "imu"]
    assert len(got_sweeps) == len(sweeps) and len(got_imus) == len(imus)
    for (t, xyz, rel), (_, t_got, xyz_got, rel_got, ring_got) in zip(sweeps, got_sweeps):
        finite = np.isfinite(xyz).all(axis=-1)
        assert abs(t_got - t) < 1e-6
        np.testing.assert_array_equal(xyz_got, xyz[finite])
        np.testing.assert_allclose(rel_got, rel[finite], atol=1e-6)
        # the `ring` PointField lands in the .liol v2 ring channel
        ring_want = (np.arange(len(xyz)) % 16).astype(np.uint16)
        np.testing.assert_array_equal(ring_got, ring_want[finite])
    for (t, acc, gyr), (_, t_got, acc_got, gyr_got) in zip(imus, got_imus):
        assert abs(t_got - t) < 1e-6
        np.testing.assert_allclose(acc_got, acc.astype(np.float32), rtol=1e-6)
        np.testing.assert_allclose(gyr_got, gyr.astype(np.float32), rtol=1e-6)


def test_convert_min_range_filter(tmp_path):
    bag, out = str(tmp_path / "demo.bag"), str(tmp_path / "seq.liol")
    with TRB.BagWriter(bag) as w:
        xyz = np.asarray([[0.1, 0.0, 0.0], [5.0, 0.0, 0.0]], np.float32)
        w.write("/velodyne_points", "sensor_msgs/PointCloud2", 1.0,
                TRB.serialize_pointcloud2(1.0, xyz))
    TRB.convert_bag(bag, out, min_range=1.0)
    items = _log_items(TN, out)
    assert [x[0] for x in items] == ["sweep"]
    np.testing.assert_array_equal(items[0][2], [[5.0, 0.0, 0.0]])
    assert items[0][4] is None  # no ring field, no ring channel


def test_relative_time_unit_normalization(tmp_path):
    bag = str(tmp_path / "demo.bag")
    xyz = np.ones((4, 3), np.float32)
    with TRB.BagWriter(bag) as w:
        w.write("/points", "sensor_msgs/PointCloud2", 1.0, TRB.serialize_pointcloud2(1.0, xyz))
    pc = TRB.parse_pointcloud2(next(iter(TRB.BagReader(bag))).raw)
    assert TRB._relative_times(pc, 0.1) is None  # no time channel
    ns = np.asarray([0, 25e6, 50e6, 99e6], np.float64)
    pc2 = TRB.parse_pointcloud2(TRB.serialize_pointcloud2(1.0, xyz, rel_time=ns.astype(np.float32)))
    np.testing.assert_allclose(TRB._relative_times(pc2, 0.1), ns * 1e-9, atol=1e-9)


def test_rosbag1x_clear_error(tmp_path):
    old = tmp_path / "old.bag"
    old.write_bytes(b"#ROSBAG V1.2\n" + b"\x00" * 64)
    with pytest.raises(IOError, match="rosbag 1.x|not a rosbag 2.0"):
        list(TRB.BagReader(str(old)))


def _lz4_bag(path):
    """A bag whose one chunk claims lz4 compression."""
    rec = TRB._make_record({b"op": bytes([TRB.OP_CHUNK]), b"compression": b"lz4",
                            b"size": struct.pack("<I", 4)}, b"\x00" * 4)
    with open(path, "wb") as f:
        f.write(TRB.MAGIC + rec)


def test_lz4_chunks_fail_as_in_the_reference(tmp_path):
    """Without the lz4 package both readers refuse with the same message."""
    try:
        import lz4.frame  # noqa: F401
    except ImportError:
        pass
    else:
        pytest.skip("the lz4 package is installed here: lz4 chunks decompress")
    bag = str(tmp_path / "lz4.bag")
    _lz4_bag(bag)
    msgs = []
    for rb in (JRB, TRB):
        with pytest.raises(IOError, match="lz4 chunk compression") as err:
            list(rb.BagReader(bag))
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_cli_bag_commands(tmp_path, capsys):
    bag, out = str(tmp_path / "demo.bag"), str(tmp_path / "seq.liol")
    _write_demo_bag(TRB, bag)
    assert TCLI.main(["bag-info", "--bag", bag]) == 0
    assert "/velodyne_points" in capsys.readouterr().out
    assert TCLI.main(["convert-bag", "--bag", bag, "--out", out]) == 0
    assert "converted 3 sweeps" in capsys.readouterr().out
    bag2 = str(tmp_path / "back.bag")
    assert TCLI.main(["export-bag", "--log", out, "--out", bag2]) == 0
    assert TRB.convert_bag(bag2, str(tmp_path / "seq2.liol"))[0] == 3


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("compression", ["none", "bz2"])
@pytest.mark.parametrize("with_ring,with_time", [(True, True), (False, False)],
                         ids=["ring-time", "plain"])
def test_writers_give_identical_bytes(tmp_path, compression, with_ring, with_time):
    paths = []
    for tag, (rb, _) in PKGS.items():
        path = tmp_path / f"{tag}.bag"
        _write_demo_bag(rb, str(path), compression, n_sweeps=5, with_time=with_time,
                        with_ring=with_ring)
        paths.append(path)
    assert paths[0].read_bytes() == paths[1].read_bytes()


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_bags_cross_read(tmp_path, writer, reader):
    bag = str(tmp_path / "x.bag")
    _write_demo_bag(PKGS[writer][0], bag, "bz2")
    mine = [(m.topic, m.msg_type, m.time, m.raw) for m in PKGS[writer][0].BagReader(bag)]
    rb = PKGS[reader][0]
    theirs = [(m.topic, m.msg_type, m.time, m.raw) for m in rb.BagReader(bag)]
    assert theirs == mine and len(mine) > 3
    assert rb.BagReader(bag).topics() == PKGS[writer][0].BagReader(bag).topics()
    for (_, ty, _, raw) in theirs:
        if ty == "sensor_msgs/PointCloud2":
            a, b = rb.parse_pointcloud2(raw), PKGS[writer][0].parse_pointcloud2(raw)
            np.testing.assert_array_equal(a.xyz(), b.xyz())
            np.testing.assert_array_equal(a.field_array("ring"), b.field_array("ring"))
        else:
            a, b = rb.parse_imu(raw), PKGS[writer][0].parse_imu(raw)
            np.testing.assert_array_equal(a.linear_acceleration, b.linear_acceleration)
            np.testing.assert_array_equal(a.angular_velocity, b.angular_velocity)


@pytest.mark.parametrize("with_ring,with_time,min_range",
                         [(True, True, 0.0), (False, True, 3.0), (True, False, 0.0)],
                         ids=["ring-time", "time-min-range", "ring-only"])
def test_convert_bag_gives_identical_logs(tmp_path, with_ring, with_time, min_range):
    bag = str(tmp_path / "x.bag")
    _write_demo_bag(TRB, bag, "bz2", n_sweeps=4, with_time=with_time, with_ring=with_ring)
    outs = []
    for tag, (rb, _) in PKGS.items():
        out = tmp_path / f"{tag}.liol"
        rb.convert_bag(bag, str(out), min_range=min_range)
        outs.append(out)
    assert outs[0].read_bytes() == outs[1].read_bytes()


def _cloud(pc_cls, name, datatype, values, n_extra_fields=0):
    """A PointCloud2 with x/y/z and one time column of PointField
    ``datatype`` (6: u32, 7: f32, 8: f64)."""
    dt = {6: np.uint32, 7: np.float32, 8: np.float64}[datatype]
    n = len(values)
    step = 12 + np.dtype(dt).itemsize
    buf = np.zeros((n, step), np.uint8)
    buf[:, 0:12] = np.arange(3 * n, dtype=np.float32).reshape(n, 3).view(np.uint8)
    buf[:, 12:] = np.ascontiguousarray(values, dt).reshape(n, 1).view(np.uint8)
    fields = [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1), (name, 12, datatype, 1)]
    return pc_cls(1.0, "lidar", 1, n, fields, False, step, step * n, buf.tobytes(), True)


@pytest.mark.parametrize("name,datatype,make", [
    ("time", 7, lambda rng, n: np.sort(rng.uniform(0, 0.1, n))),            # Velodyne
    ("t", 6, lambda rng, n: np.sort(rng.integers(0, 99_000_000, n))),       # Ouster ns
    ("timestamp", 8, lambda rng, n: 1.6e9 + np.sort(rng.uniform(0, 0.1, n))),  # Hesai
    ("time", 7, lambda rng, n: np.sort(rng.uniform(0, 99_000.0, n))),       # microseconds
    ("timestamp", 8, lambda rng, n: 1.6e9 + np.sort(rng.uniform(0, 5.0, n))),  # not a sweep
], ids=["velodyne-f32", "ouster-u32-ns", "hesai-f64", "f32-us", "f64-too-long"])
def test_relative_times_agree(name, datatype, make):
    vals = make(np.random.default_rng(3), 500)
    got = [rb._relative_times(_cloud(rb.PointCloud2, name, datatype, vals), 0.1)
           for rb in (JRB, TRB)]
    if got[0] is None:
        assert got[1] is None and name == "timestamp"
        return
    assert got[1].dtype == got[0].dtype == np.float32
    np.testing.assert_array_equal(got[1], got[0])
    assert 0.0 <= got[1].min() and got[1].max() <= 0.1


def test_cli_prints_and_writes_as_the_reference(tmp_path, capsys):
    bag = str(tmp_path / "demo.bag")
    _write_demo_bag(TRB, bag, "bz2", n_sweeps=4)
    runs = {}
    for tag, mod in (("ref", JCLI), ("port", TCLI)):
        d = tmp_path / tag
        d.mkdir()
        log = str(d / "seq.liol")
        assert mod.main(["bag-info", "--bag", bag]) == 0
        assert mod.main(["convert-bag", "--bag", bag, "--out", log, "--min-range", "2.0"]) == 0
        assert mod.main(["export-bag", "--log", log, "--out", str(d / "out.bag")]) == 0
        assert mod.main(["export-bag", "--log", log, "--out", str(d / "raw.bag"),
                         "--compression", "none", "--points-topic", "/points"]) == 0
        assert mod.main(["convert-bag", "--bag", bag, "--out", str(d / "none.liol"),
                         "--points-topic", "/nothing"]) == 1
        runs[tag] = capsys.readouterr().out.replace(str(d), "<d>")
        for name in ("seq.liol", "out.bag", "raw.bag"):
            runs[tag, name] = (d / name).read_bytes()
    assert runs["port"] == runs["ref"]
    assert "warning: no sweeps converted" in runs["port"]
    for name in ("seq.liol", "out.bag", "raw.bag"):
        assert runs["port", name] == runs["ref", name], name


# ---------------------------------------------------------------------------
# end to end at the small profile
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """simulate -> export-bag -> convert-bag (twice) through the port."""
    d = tmp_path_factory.mktemp("bag_e2e")
    p = lambda name: str(d / name)  # noqa: E731
    assert TCLI.main(["simulate", "--out", p("seq.liol"), "--sweeps", str(N_E2E),
                      "--azimuth", "300", "--gt-out", p("gt.tum")]) == 0
    assert TCLI.main(["export-bag", "--log", p("seq.liol"), "--out", p("seq.bag")]) == 0
    assert TCLI.main(["convert-bag", "--bag", p("seq.bag"), "--out", p("rt.liol")]) == 0
    assert TCLI.main(["export-bag", "--log", p("rt.liol"), "--out", p("rt.bag")]) == 0
    assert TCLI.main(["convert-bag", "--bag", p("rt.bag"), "--out", p("rt2.liol")]) == 0
    return d


def test_bag_round_trip_keeps_the_log(e2e):
    a, b = _log_items(TN, e2e / "seq.liol"), _log_items(TN, e2e / "rt.liol")
    assert [x[0] for x in a] == [x[0] for x in b] and len(a) > N_E2E
    for x, y in zip(a, b):
        assert abs(x[1] - y[1]) <= 1e-9  # ROS time: integer nanoseconds
        for u, v in zip(x[2:], y[2:]):
            if u is None:
                assert v is None  # simulate writes no rings
            else:
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)
    # a log that went through the bag once is a fixed point
    assert (e2e / "rt.liol").read_bytes() == (e2e / "rt2.liol").read_bytes()


def test_bag_round_trip_feeds_run_the_same_inputs(e2e, tmp_path, monkeypatch, capsys):
    from lio_mapping_tpu_torch.models import pipeline as TPL

    from tests.test_torch_cli import _stub

    records = {}
    real = TPL.LioPipeline
    for log in ("seq.liol", "rt.liol"):
        rec = records[log] = []
        monkeypatch.setattr(TPL, "LioPipeline", _stub(real, rec))
        assert TCLI.main(["run", "--log", str(e2e / log), "--profile", "indoor",
                          "--device", "cpu", "--out", str(tmp_path / f"{log}.tum")]) == 0
    capsys.readouterr()
    a, b = records["seq.liol"], records["rt.liol"]
    assert len(a) == len(b) == N_E2E - 1
    n_moved = 0
    for (pf_a, xyz_a, m_a, s_a), (pf_b, xyz_b, m_b, s_b) in zip(a, b):
        assert pf_a == pf_b
        np.testing.assert_array_equal(xyz_a, xyz_b)
        np.testing.assert_array_equal(m_a, m_b)
        np.testing.assert_array_equal(s_a[0], s_b[0])  # acc0, gyr0
        # the sample rows with dt above the stamps' 1e-9 s agree
        keep_a, keep_b = s_a[1:, 0] > 1e-9, s_b[1:, 0] > 1e-9
        np.testing.assert_array_equal(s_a[1:][keep_a][:, 1:], s_b[1:][keep_b][:, 1:])
        np.testing.assert_allclose(s_a[1:][keep_a][:, 0], s_b[1:][keep_b][:, 0], rtol=0,
                                   atol=1e-9)
        n_moved += int(np.count_nonzero(s_a[1:, 0]) != np.count_nonzero(s_b[1:, 0]))
    # the boundary sample sits on t + msg_time_delay after the round trip on
    # some pairs (an extra row with dt < 1e-9 s), not all
    assert 0 < n_moved < N_E2E - 1


def _small_yaml(path, **sensor):
    prof = copy.deepcopy(SMALL_PROFILE)
    prof["feature"] = {"corner_sharp_cap": 128, "corner_less_sharp_cap": 1024,
                       "surf_flat_cap": 256, "surf_less_flat_cap": 2048}
    if sensor:
        prof["sensor"] = sensor
    with open(path, "w") as f:
        yaml.safe_dump(prof, f)
    return str(path)


@pytest.fixture(scope="module")
def _one_thread():
    """One intra-op thread for the CPU run (small ops; see test_torch_cli)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ring_annotated_uneven_e2e(e2e, capsys, _one_thread):
    """tests/test_cli_e2e.py::test_ring_annotated_uneven_e2e on the port: a
    bag whose clouds carry only the driver's ``ring`` field drives the CLI
    loop under a ``sensor.uneven`` profile (feature capacities narrowed as
    in test_torch_cli to keep it to a minute)."""
    bag, log_r = str(e2e / "ring.bag"), str(e2e / "ring.liol")
    n_rings, lo, hi = 16, -15.0, 15.0
    factor = (n_rings - 1) / (hi - lo)
    with TRB.BagWriter(bag, compression="bz2") as w:
        for item in TN.SequenceLog(str(e2e / "rt.liol")):
            if item[0] == "imu":
                _, t, acc, gyr = item
                w.write("/imu/data", "sensor_msgs/Imu", t, TRB.serialize_imu(t, acc, gyr))
            else:
                t, xyz = item[1], item[2]
                ele = np.degrees(np.arctan2(xyz[:, 2], np.hypot(xyz[:, 0], xyz[:, 1])))
                ring = np.floor((ele - lo) * factor + 0.5).astype(np.int32)
                keep = (ring >= 0) & (ring < n_rings)
                w.write("/velodyne_points", "sensor_msgs/PointCloud2", t,
                        TRB.serialize_pointcloud2(t, xyz[keep], None, ring[keep].astype(np.uint16)))
    assert TCLI.main(["convert-bag", "--bag", bag, "--out", log_r]) == 0
    rings = [x[4] for x in TN.SequenceLog(log_r) if x[0] == "sweep"]
    assert len(rings) == N_E2E and all(r is not None and r.max() < n_rings for r in rings)

    cfg = _small_yaml(e2e / "uneven.yaml", uneven=True)
    traj = str(e2e / "traj_uneven.tum")
    assert TCLI.main(["run", "--log", log_r, "--config", cfg, "--device", "cpu",
                      "--out", traj]) == 0
    assert "stage: INITED" in capsys.readouterr().out
    assert TCLI.main(["evaluate", "--est", traj, "--gt", str(e2e / "gt.tum")]) == 0
    ate = float(re.search(r"ATE RMSE: ([0-9.]+) m", capsys.readouterr().out).group(1))
    assert ate < 0.45, f"uneven-profile CLI loop ATE {ate} m"
    assert len(load_tum(traj)[0]) == N_E2E - 1

    # an uneven profile without ring data fails loudly
    with pytest.raises(ValueError, match="ring"):
        TCLI.main(["run", "--log", str(e2e / "seq.liol"), "--config", cfg, "--device", "cpu",
                   "--out", str(e2e / "nope.tum")])
    assert not os.path.exists(e2e / "nope.tum")
