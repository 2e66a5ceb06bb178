"""The port's visualisation exports (``lio_mapping_tpu_torch/io/viz.py``) and
its ``plot-traj`` / ``viz-normals`` commands against the reference's
(``lio_mapping_tpu``), on the CPU.

* ``save_euler_csv``, ``save_ply_normals`` and ``save_ply_cloud`` write
  the same text on the same inputs (made from a seed).
* ``plot-traj`` writes a PNG and the same euler CSV (skipped, with the
  reason, where matplotlib is missing).
* ``viz-normals --device cpu`` on the 6-sweep log of
  ``tests/test_cli.py::test_plot_traj_and_viz_normals``: the same local
  map, the same features at the same positions and the same 5-NN sets.
  The normals and scores agree to the PLY's last digit (1e-4) on most
  rows, not all: both packages fit ``A x = -1`` in float32 by the same
  Gram-Schmidt QR, but XLA sums each 5-term dot product in order and torch
  vectorises it, and on near-degenerate neighbourhoods (points ~15 m out,
  a few mm thick) the last-ulp difference grows to 1e-3 .. 0.2 in the
  normal. There the float64 fit through the same neighbours is the
  judge: the port's normals and scores must be no farther from it, in
  RMS, than the reference's.
* Without CUDA, ``viz-normals`` stops unless told ``--device cpu``.
"""

import numpy as np
import pytest
import torch

from lio_mapping_tpu import cli as JCLI
from lio_mapping_tpu.io import viz as JV
from lio_mapping_tpu_torch import cli as TCLI
from lio_mapping_tpu_torch.io import viz as TV

EPS32 = float(np.finfo(np.float32).eps)
PLY_HEADER_LINES = 11  # save_ply_normals with scores


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    d = tmp_path_factory.mktemp("viz")
    log, gt = str(d / "seq.liol"), str(d / "gt.tum")
    assert TCLI.main(["simulate", "--out", log, "--sweeps", "6", "--azimuth", "240",
                      "--gt-out", gt]) == 0
    return {"dir": d, "log": log, "gt": gt}


def _qs(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("writer", ["euler_csv", "ply_normals", "ply_normals_no_scores",
                                    "ply_cloud"])
def test_writers_give_the_reference_text(tmp_path, writer):
    rng = np.random.default_rng(7)
    n = 257
    xyz = rng.normal(scale=20.0, size=(n, 3))
    normals = rng.normal(size=(n, 3))
    scores = rng.uniform(0, 1, n)
    times = np.cumsum(rng.uniform(0.05, 0.15, n))
    paths = []
    for mod, tag in ((JV, "ref"), (TV, "port")):
        path = str(tmp_path / f"{tag}.txt")
        if writer == "euler_csv":
            mod.save_euler_csv(path, times, _qs(np.random.default_rng(8), n))
        elif writer == "ply_normals":
            mod.save_ply_normals(path, xyz, normals, scores)
        elif writer == "ply_normals_no_scores":
            mod.save_ply_normals(path, xyz.astype(np.float32), normals)
        else:
            mod.save_ply_cloud(path, xyz)
        paths.append(path)
    ref, port = (open(p).read() for p in paths)
    assert port == ref and len(port.splitlines()) > n


def test_plot_traj_writes_the_dashboard(seq, tmp_path, capsys):
    pytest.importorskip("matplotlib", reason="plot-traj needs matplotlib, absent here")
    png, csv = str(tmp_path / "dash.png"), str(tmp_path / "euler.csv")
    assert TCLI.main(["plot-traj", "--est", seq["gt"], "--gt", seq["gt"], "--out", png,
                      "--euler-csv", csv, "--title", "port"]) == 0
    out = capsys.readouterr().out
    assert out.splitlines() == [f"wrote {png}", f"wrote {csv}"]
    with open(png, "rb") as f:
        head = f.read()
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and len(head) > 1000
    ref_csv = str(tmp_path / "ref.csv")
    assert JCLI.main(["plot-traj", "--est", seq["gt"], "--out", str(tmp_path / "ref.png"),
                      "--euler-csv", ref_csv]) == 0
    assert open(csv).read() == open(ref_csv).read()


def _ply(path):
    with open(path) as f:
        head = [next(f) for _ in range(PLY_HEADER_LINES)]
    assert head[-1] == "end_header\n" and "property float quality\n" in head
    rows = np.loadtxt(path, skiprows=PLY_HEADER_LINES, ndmin=2)
    assert len(rows) == int(head[2].split()[-1])
    return rows


@pytest.fixture(scope="module")
def normals_runs(seq):
    d = seq["dir"]
    common = ["viz-normals", "--log", seq["log"], "--traj", seq["gt"], "--frames", "4"]
    assert JCLI.main(common + ["--out", str(d / "ref.ply"), "--map-out",
                               str(d / "ref_map.ply")]) == 0
    assert TCLI.main(common + ["--out", str(d / "port.ply"), "--map-out",
                               str(d / "port_map.ply"), "--device", "cpu"]) == 0
    return _ply(d / "ref.ply"), _ply(d / "port.ply")


def test_viz_normals_matches_the_reference(seq, normals_runs):
    from lio_mapping_tpu.config import LioConfig as JConfig
    from lio_mapping_tpu.models import estimator as JEST
    from lio_mapping_tpu_torch.config import LioConfig
    from lio_mapping_tpu_torch.models import estimator as TEST

    import jax.numpy as jnp

    ref, port = normals_runs
    d = seq["dir"]
    assert (d / "ref_map.ply").read_text() == (d / "port_map.ply").read_text()
    assert len(port) == len(ref) > 500
    np.testing.assert_array_equal(port[:, :3], ref[:, :3])

    # the rows behind the PLY: the same 5-NN sets in both packages
    view = TCLI.normals_view(seq["log"], seq["gt"], LioConfig.indoor(), frames=4, device="cpu")
    # the same rows the PLY printed to four decimals
    np.testing.assert_allclose(view.xyz[view.ok], port[:, :3], rtol=0, atol=5.1e-5)
    cap = LioConfig.indoor().estimator.local_map_filtered_cap
    map_xyz = np.zeros((cap, 3), np.float32)
    map_xyz[:len(view.map_xyz)] = view.map_xyz
    map_mask = np.arange(cap) < len(view.map_xyz)
    q = view.xyz[view.ok]
    q_mask = np.ones(len(q), bool)
    _, nb = TEST.make_knn5(torch.as_tensor(map_xyz), torch.as_tensor(map_mask),
                           LioConfig.indoor())(torch.as_tensor(q), torch.as_tensor(q_mask))
    _, nb_ref = JEST.make_knn5(jnp.asarray(map_xyz), jnp.asarray(map_mask),
                               JConfig.indoor())(jnp.asarray(q), jnp.asarray(q_mask))
    nb = nb.numpy()
    np.testing.assert_array_equal(nb, np.asarray(nb_ref))

    # the float64 plane fit through those neighbours (w.p + d = 0, |w| = 1)
    a = nb.astype(np.float64)
    x64 = np.stack([np.linalg.lstsq(m, -np.ones(5), rcond=None)[0] for m in a])
    n64 = x64 / np.linalg.norm(x64, axis=1, keepdims=True)
    s64 = 1.0 - 0.9 * np.abs(np.sum(n64 * q, axis=1) + 1.0 / np.linalg.norm(x64, axis=1)) \
        / np.sqrt(np.linalg.norm(q.astype(np.float64), axis=1))
    dn = np.abs(port[:, 3:6] - ref[:, 3:6]).max(axis=1)
    ds = np.abs(port[:, 6] - ref[:, 6])
    err_n = {k: np.abs(v[:, 3:6] - n64).max(axis=1) for k, v in (("port", port), ("ref", ref))}
    err_s = {k: np.abs(v[:, 6] - s64) for k, v in (("port", port), ("ref", ref))}
    # within the PLY's last digit on most rows (91% of normals, 99.7% of
    # scores on this log); where not, the float32 fit is noise in both
    # packages, and the port's is the nearer to the float64 fit
    tol = 1e-4 + 1e-9
    assert np.median(dn) <= tol and np.median(ds) <= tol
    assert np.mean(dn <= tol) >= 0.85 and np.mean(ds <= tol) >= 0.95
    rms = lambda e: float(np.sqrt(np.mean(e ** 2)))  # noqa: E731
    assert rms(err_n["port"]) <= rms(err_n["ref"]) and rms(err_s["port"]) <= rms(err_s["ref"])
    # and the printed normals are unit vectors
    np.testing.assert_allclose(np.linalg.norm(port[:, 3:6], axis=1), 1.0, atol=3e-4)


def test_viz_normals_needs_cuda_unless_told_cpu(seq, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "n.ply"
    rc = TCLI.main(["viz-normals", "--log", seq["log"], "--traj", seq["gt"], "--out", str(out)])
    assert rc != 0
    assert "CUDA is not available" in capsys.readouterr().err
    assert not out.exists()


def test_viz_normals_needs_two_posed_sweeps(seq, tmp_path, capsys):
    far = tmp_path / "far.tum"
    far.write_text("1000.0 0 0 0 0 0 0 1\n1000.1 0 0 0 0 0 0 1\n")
    rc = TCLI.main(["viz-normals", "--log", seq["log"], "--traj", str(far),
                    "--out", str(tmp_path / "n.ply"), "--device", "cpu"])
    assert rc == 1 and capsys.readouterr().out == "not enough posed sweeps\n"
