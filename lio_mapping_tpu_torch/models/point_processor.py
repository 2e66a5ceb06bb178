"""Front-end stage: raw sweep -> LOAM features
(port of lio_mapping_tpu.models.point_processor)."""

from __future__ import annotations

import math
from collections import deque

import numpy as np
import torch

from ..config import LioConfig
from ..ops import features as F
from ..ops import ring as R
from ..ops.features import SweepFeatures


def process_sweep(xyz: torch.Tensor, mask: torch.Tensor, cfg: LioConfig,
                  start_ori=None, ring_ids=None) -> SweepFeatures:
    """Raw (N,3) sweep in the sensor frame -> feature clouds, on the
    device of ``xyz``. ``start_ori``: inferred start azimuth
    (:class:`StartOriTracker`); ``ring_ids``: per-point rings for the
    ``uneven`` rigs."""
    s = cfg.sensor
    rc, so = R.project_to_rings(
        xyz, mask,
        n_rings=s.n_rings,
        lower_bound_deg=s.lower_bound_deg,
        upper_bound_deg=s.upper_bound_deg,
        max_points_per_ring=s.max_points_per_ring,
        scan_period=s.scan_period,
        start_ori_override=start_ori,
        ring_ids=ring_ids if s.uneven else None,
    )
    return F.extract_features(rc, so, cfg.feature, s)


def _normalize_rad(a: float) -> float:
    """Wrap to (-pi, pi] (math_utils.h NormalizeRad)."""
    a = math.fmod(a, 2.0 * math.pi)
    if a > math.pi:
        a -= 2.0 * math.pi
    elif a <= -math.pi:
        a += 2.0 * math.pi
    return a


def raw_start_ori(xyz, mask) -> float:
    """Observed start azimuth of a sweep: ``2*pi - atan2(y, x)`` of the
    first valid point in scan order (PointProcessor.cc:248-267)."""
    xyz = np.asarray(xyz)
    v = np.asarray(mask) & np.all(np.isfinite(xyz), axis=-1)
    i = int(np.argmax(v))
    azi = 2.0 * math.pi - math.atan2(float(xyz[i, 1]), float(xyz[i, 0]))
    if azi >= 2.0 * math.pi:
        azi -= 2.0 * math.pi
    return azi


class StartOriTracker:
    """Host-side start-azimuth smoother (the reference's ``infer_start_ori``
    mode, PointProcessor.cc:348-389); see the reference class for the rule."""

    STEP_TOL = 0.05

    def __init__(self, rad_diff: float):
        self.rad_diff = float(rad_diff)
        self._buf1 = deque(maxlen=10)  # accepted / inferred
        self._buf2 = deque(maxlen=10)  # raw observations

    def update(self, raw: float) -> float:
        start = float(raw)
        self._buf2.append(float(raw))
        if len(self._buf1) >= 10:
            step1 = _normalize_rad(self._buf1[-1] - self._buf1[0]) / 9.0
            step2 = _normalize_rad(self._buf2[-1] - self._buf2[0]) / 9.0
            if abs(_normalize_rad(start - self._buf1[-1])) > self.rad_diff:
                start = _normalize_rad(self._buf1[-1] + step1)
                if start < 0:
                    start += 2.0 * math.pi
            consistent = abs(_normalize_rad(step1 - step2)) < self.STEP_TOL and all(
                abs(_normalize_rad(self._buf2[k + 1] - self._buf2[k] - step1)) < self.STEP_TOL
                for k in range(9))
            if consistent:
                start = float(raw)
        self._buf1.append(start)
        return start
