"""The reference's error arithmetic and the faults it has to catch."""

import math

import numpy as np
import torch
from scipy.spatial.transform import Rotation

from bench_stub import tiny_cell
from harness import reference as REF
from harness.cell import judge, plant


def test_alignment_recovers_a_rigid_motion():
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(50, 3))
    r = Rotation.from_euler("zyx", [0.7, -0.2, 0.1]).as_matrix()
    est = (gt - 3.0) @ r          # est = R^T (gt - 3)
    r_hat, t_hat = REF.align_se3(est, gt)
    np.testing.assert_allclose(est @ r_hat.T + t_hat, gt, atol=1e-9)


def test_the_truth_reads_zero_and_each_fault_reads_high():
    cell, _, mode = tiny_cell("indoor-4d-replay")
    ks = np.arange(60, 260)
    q, t = REF.gt_poses(cell.config, ks)
    poses = {"k": ks, "q": q, "t": t}
    sound = judge(cell, mode, poses, True)
    assert sound["ate_max_m"] < 1e-9 and sound["rpe_max_m"] < 1e-9
    for fault in ("frozen", "altered"):
        nums = judge(cell, mode, plant(fault, poses, 2 ** 31 + 9), True)
        assert nums["ate_max_m"] > 0.9, fault
    assert judge(cell, mode, poses, False)["not_inited"] == 1.0


def _builder_steps(dtype, n_steps=4, cap=4096):
    """The program's eager 4D builder step (``MapBuilder``'s step on the
    CPU) over a few sweeps of the indoor loop at a 180-step azimuth and
    ``cap``-row maps, each step beside the reference's: yields (the
    program's pose, the reference's pose, map rows apart)."""
    import dataclasses
    import json

    from bench_stub import BENCH
    from harness import drive, world
    from harness import scan_to_map as S2M
    from harness.cell import port_config
    from lio_mapping_tpu_torch.models import map_builder as MB
    from lio_mapping_tpu_torch.ops.cloud import Cloud
    from lio_mapping_tpu_torch.utils.se3 import Pose

    conf = json.loads((BENCH / "configs" / "indoor_vlp16.json").read_text())
    conf["sensor"]["n_azimuth"] = 180
    cfg = port_config(conf)
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping, map_cloud_cap=cap))
    mc = S2M.params(conf)
    host = world.Loop(conf, 2 ** 31 + 5, "cpu").to_host()
    state = MB.init_state(cfg, dtype, "cpu")
    rng = np.random.default_rng(0)

    def cloud(xyz, mask):
        n = len(xyz)
        return Cloud(xyz=xyz.to(dtype), rel_time=torch.zeros(n, dtype=dtype),
                     ring=torch.zeros(n, dtype=torch.int32), mask=mask)

    for k in range(0, 2 * n_steps, 2):
        xyz, mask = (torch.as_tensor(a) for a in host.sweep(k)[:2])
        corner, surf = cloud(xyz[::5], mask[::5]), cloud(xyz, mask)
        q, p = REF.gt_poses(conf, [k])
        odom = Pose(torch.tensor(q[0], dtype=dtype),
                    torch.tensor(p[0] + rng.normal(scale=0.03, size=3), dtype=dtype))
        snap = drive.builder_inputs(state, corner, surf, (odom.q, odom.t))
        state, out = MB.map_builder_step(state, corner, surf, odom, cfg)
        snap.update(drive.builder_maps(state, "after_"))
        ref, _, stacks = S2M.refine(snap, mc)
        prog = S2M.Pose(out["pose"].q, out["pose"].t)
        c, s = S2M.insert_stacks(snap, stacks, prog, mc)
        apart = (S2M.rows_apart(snap["after_corner_xyz"], snap["after_corner_mask"], *c, 1e-4)
                 + S2M.rows_apart(snap["after_surf_xyz"], snap["after_surf_mask"], *s, 1e-4))
        yield prog, ref, apart


def test_the_reference_step_is_the_program_s_step_worked_in_float64():
    """The program's builder step run in float64 gives the reference's
    pose and maps: the reference works out the same step."""
    from harness import scan_to_map as S2M

    moved = 0.0
    for prog, ref, apart in _builder_steps(torch.float64):
        assert float(np.linalg.norm(prog.t - ref.t)) < 1e-6
        assert math.degrees(float(S2M.angle_between(prog.q, ref.q))) < 1e-5
        assert apart == 0
        moved = max(moved, float(np.linalg.norm(prog.t)))
    assert moved > 0.1, "the steps moved the pose"

