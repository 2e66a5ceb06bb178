"""The generator: the slot count of every sweep, a trajectory and a mask
that the seed does not change, the IMU against the trajectory, the loop's
period and the motion compensation."""

import copy
import json

import numpy as np
import pytest
import torch

from bench_stub import BENCH
from harness import reference as REF
from harness import world

CONFIGS = sorted(p.stem for p in (BENCH / "configs").glob("*.json"))


def small(name: str, n_azimuth: int = 90) -> dict:
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    conf["sensor"]["n_azimuth"] = n_azimuth
    return conf


@pytest.mark.parametrize("name", CONFIGS)
def test_every_sweep_has_the_stated_slots(name):
    conf = small(name)
    loop = world.Loop(conf, 2 ** 31 + 77, "cpu")
    s = conf["sensor"]
    slots = s["n_rings"] * s["n_azimuth"]
    assert loop.xyz.shape == (conf["sequence"]["loop_sweeps"], slots, 3)
    assert loop.mask.shape == loop.xyz.shape[:2]
    assert loop.mask.float().mean() > 0.3, "most slots return"
    host = loop.to_host()
    xyz, mask, dts, acc, gyr, acc0, gyr0 = host.sweep(12345)
    assert xyz.shape == (slots, 3) and xyz.dtype == np.float32 and mask.dtype == bool
    assert len(dts) == len(acc) == len(gyr) == round(s["scan_period"] * conf["imu"]["rate_hz"])


def test_the_seed_changes_the_noise_only():
    conf = small("indoor_vlp16")
    a = world.Loop(conf, 1, "cpu")
    b = world.Loop(conf, 2 ** 33 + 5, "cpu")
    assert torch.equal(a.mask, b.mask)
    gap = (a.xyz - b.xyz)[a.mask].norm(dim=-1)
    assert 0 < float(gap.median()) < 6 * conf["sensor"]["range_noise_m"]
    again = world.Loop(conf, 1, "cpu")
    assert torch.equal(a.xyz, again.xyz) and torch.equal(a.imu_acc, again.imu_acc)


def test_noise_free_points_lie_on_the_world_and_the_imu_is_exact():
    conf = small("indoor_vlp16")
    conf["sensor"]["range_noise_m"] = 0.0
    conf["imu"]["acc_noise"] = conf["imu"]["gyr_noise"] = 0.0
    loop = world.Loop(conf, 0, "cpu")
    host = loop.to_host()
    # a point of sweep 7, firing at its azimuth step's time, lies on a face
    k, slot = 7, 5 * conf["sensor"]["n_rings"] + 3
    t = torch.tensor([(k + (slot // conf["sensor"]["n_rings"]) / 90) * 0.1], dtype=torch.float64)
    r, p = world.sensor_poses(conf["trajectory"], world.rig_of(conf), t)
    w = (r[0] @ torch.as_tensor(host.xyz[k, slot], dtype=torch.float64)) + p[0]
    room = torch.tensor(conf["world"]["room"], dtype=torch.float64)
    boxes = torch.tensor(conf["world"]["boxes"], dtype=torch.float64)
    faces = torch.cat([(w - room).abs().flatten(), (w - boxes).abs().flatten()])
    assert float(faces.min()) < 1e-3
    # the gyro of sample j is the trajectory's body rate at j / rate
    j = 41
    _, _, _, _, omega = world.trajectory_state(conf["trajectory"],
                                              torch.tensor([j / conf["imu"]["rate_hz"]],
                                                           dtype=torch.float64))
    torch.testing.assert_close(loop.imu_gyr[j], omega[0])


def test_a_trajectory_that_does_not_repeat_is_refused():
    conf = small("indoor_vlp16")
    conf["sequence"]["loop_sweeps"] = 150
    with pytest.raises(ValueError, match="does not repeat"):
        world.Loop(conf, 0, "cpu")


def test_motion_compensation_keeps_a_still_sensor_still():
    conf = small("indoor_vlp16")
    still = copy.deepcopy(conf)
    for key in ("yaw_amp", "pitch_amp", "roll_amp"):
        still["trajectory"][key] = 0.0
    still["trajectory"]["pos_amp"] = [0.0, 0.0, 0.0]
    raw = world.Loop(still, 3, "cpu")
    still["sensor"]["deskewed"] = True
    comp = world.Loop(still, 3, "cpu")
    torch.testing.assert_close(raw.xyz, comp.xyz, atol=1e-4, rtol=0)


def test_ground_truth_poses_repeat_with_the_loop():
    conf = small("indoor_vlp16")
    q0, p0 = REF.gt_poses(conf, [3, 203, 403])
    np.testing.assert_allclose(p0[0], p0[1], atol=1e-9)
    np.testing.assert_allclose(q0[0], q0[2], atol=1e-9)
