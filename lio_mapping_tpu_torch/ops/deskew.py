"""Motion de-skew by per-point pose interpolation
(port of lio_mapping_tpu.ops.deskew; PointOdometry.cc:237-292)."""

from __future__ import annotations

import torch

from ..utils import quaternion as quat
from .cloud import Cloud


def transform_to_start(xyz, rel_time, q_es, t_es, scan_period: float, enabled: bool = True):
    """Per-point deskew to sweep start: with s = rel_time / scan_period,
    p_start = slerp(I, q_es, s)^-1 (p - s * t_es)."""
    if not enabled:
        return xyz
    s = torch.clamp(rel_time / scan_period, 0.0, 1.001)[..., None]
    p = xyz - s * t_es
    shape = xyz.shape[:-1] + (4,)
    q_s = quat.slerp(quat.identity(q_es.dtype, q_es.device).expand(shape),
                     q_es.expand(shape), s[..., 0])
    return quat.rotate(quat.conjugate(q_s), p)


def transform_to_end(xyz, rel_time, q_es, t_es, scan_period: float, enabled: bool = True):
    """Per-point re-projection to sweep end (TransformToEnd)."""
    p_start = transform_to_start(xyz, rel_time, q_es, t_es, scan_period, enabled)
    return quat.rotate(q_es, p_start) + t_es


def cloud_to_end(c: Cloud, q_es, t_es, scan_period: float, enabled: bool = True) -> Cloud:
    new_xyz = transform_to_end(c.xyz, c.rel_time, q_es, t_es, scan_period, enabled)
    return c._replace(xyz=new_xyz, rel_time=torch.zeros_like(c.rel_time))
