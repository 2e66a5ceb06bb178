"""Configuration dataclasses for the LIO engine (copy of lio_mapping_tpu.config).

Mirrors the reference's three config mechanisms (SURVEY §5-config):
* ``estimator_node.cc:62-140``  YAML -> EstimatorConfig
* ``PointProcessor.h:104-120``  PointProcessorConfig defaults
* launch-file ROS params (sensor_type, ...)

Shipped profiles (``configs/*.yaml`` here) correspond to the reference's
``config/indoor_test_config.yaml``, ``outdoor_test_config.yaml`` and
``outdoor_test_config_64.yaml``.

All *_cap fields are TPU additions: fixed array capacities replacing
dynamically sized PCL clouds (XLA requires static shapes).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


@dataclass(frozen=True)
class SensorConfig:
    """LiDAR geometry (processor_node.cc:55-75)."""

    n_rings: int = 16
    lower_bound_deg: float = -15.0
    upper_bound_deg: float = 15.0
    max_points_per_ring: int = 2048
    scan_period: float = 0.1
    # start-azimuth inference across sweeps (PointProcessor.cc:348-389;
    # `infer_start_ori` ROS param, off by default; `rad_diff` launch param,
    # 0.2 outdoor / 1.0 indoor, processor_node.cc:63)
    infer_start_ori: bool = False
    rad_diff: float = 0.2
    # unevenly-spaced lasers: ring index comes from the per-point ring
    # annotation instead of elevation binning (sensor_type 320,
    # processor_node.cc:72-74)
    uneven: bool = False

    @property
    def ring_factor(self) -> float:
        """(n_rings - 1) / (upper - lower): ElevationToRing (PointProcessor.h:153-156)."""
        return (self.n_rings - 1) / (self.upper_bound_deg - self.lower_bound_deg)

    @staticmethod
    def vlp16() -> "SensorConfig":
        return SensorConfig(16, -15.0, 15.0, 2048, 0.1)

    @staticmethod
    def hdl32() -> "SensorConfig":
        return SensorConfig(32, -30.67, 10.67, 2304, 0.1)

    @staticmethod
    def hdl64() -> "SensorConfig":
        return SensorConfig(64, -24.9, 2.0, 2304, 0.1)

    @staticmethod
    def rs32_uneven() -> "SensorConfig":
        """sensor_type 320: ring-annotated 32-laser rig (processor_node.cc:72-74)."""
        return SensorConfig(32, -25.0, 15.0, 2304, 0.1, uneven=True)

    @staticmethod
    def by_type(sensor_type: int) -> "SensorConfig":
        return {16: SensorConfig.vlp16, 32: SensorConfig.hdl32,
                64: SensorConfig.hdl64, 320: SensorConfig.rs32_uneven}[sensor_type]()


@dataclass(frozen=True)
class FeatureConfig:
    """LOAM feature extraction (PointProcessor.h:104-120)."""

    num_scan_subregions: int = 8
    num_curvature_regions: int = 5
    surf_curv_th: float = 0.1
    max_corner_sharp: int = 2
    max_corner_less_sharp: int = 20
    max_surf_flat: int = 4
    less_flat_filter_size: float = 0.2

    # --- TPU capacities (per sweep) ---
    corner_sharp_cap: int = 512
    corner_less_sharp_cap: int = 4096
    surf_flat_cap: int = 1024
    surf_less_flat_cap: int = 8192


@dataclass(frozen=True)
class OdometryConfig:
    """Scan-to-scan GN (PointOdometry.cc:67-104)."""

    max_iterations: int = 25
    delta_r_abort_deg: float = 0.1
    delta_t_abort_cm: float = 0.1
    reassociate_every: int = 5  # kdtree re-search every 5th iter (PointOdometry.cc:344)
    nearest_sq_dist_th: float = 25.0
    weight_start_iter: int = 5  # s = 1 - 1.8|d| only from iter 5 (PointOdometry.cc:422)
    degeneracy_eigen_th: float = 10.0
    ring_search_range: float = 2.5
    min_corner_points: int = 10
    min_surf_points: int = 100
    io_ratio: int = 2


@dataclass(frozen=True)
class MappingConfig:
    """Scan-to-map refinement + cube map (PointMapping.cc:68-118)."""

    max_iterations: int = 10
    delta_r_abort_deg: float = 0.05
    delta_t_abort_cm: float = 0.05
    min_match_sq_dis: float = 1.0
    min_plane_dis: float = 0.2
    degeneracy_eigen_th: float = 100.0
    corner_filter_size: float = 0.2
    surf_filter_size: float = 0.4
    map_filter_size: float = 0.6
    # 21 x 21 x 11 cubes of 50 m (PointMapping.cc:77-83)
    cube_length: int = 21
    cube_width: int = 21
    cube_height: int = 11
    cube_size_m: float = 50.0
    # TPU capacities
    cube_point_cap: int = 1024
    map_cloud_cap: int = 65536
    stack_cap: int = 16384


@dataclass(frozen=True)
class ImuConfig:
    """IMU noise model (IntegrationBase.h:64-70 / yaml acc_n..g_norm)."""

    acc_n: float = 0.2
    gyr_n: float = 0.02
    acc_w: float = 2.0e-4
    gyr_w: float = 2.0e-5
    g_norm: float = 9.805
    # samples per CONSUMED frame: the estimator's preintegration interval
    # spans io_ratio sweeps (odom_io 2/3) — and during initialization
    # io_ratio * init_window_factor sweeps — at IMU rates up to ~200 Hz
    max_imu_per_frame: int = 96


@dataclass(frozen=True)
class EstimatorConfig:
    """Sliding-window estimator (Estimator.h:77-108, yaml profiles)."""

    window_size: int = 12
    opt_window_size: int = 7
    init_window_factor: int = 2

    min_match_sq_dis: float = 1.0
    min_plane_dis: float = 0.2

    corner_filter_size: float = 0.2
    surf_filter_size: float = 0.4
    map_filter_size: float = 0.6

    estimate_extrinsic: int = 2  # 0 fixed / 1 refine / 2 calibrate from scratch
    opt_extrinsic: bool = True
    extrinsic_rotation: Tuple[float, ...] = (1, 0, 0, 0, 1, 0, 0, 0, 1)  # row-major R_lb
    extrinsic_translation: Tuple[float, ...] = (0.0, 0.0, -0.081939)  # t_lb

    run_optimization: bool = True
    update_laser_imu: bool = True
    gravity_fix: bool = True
    plane_projection_factor: bool = False
    imu_factor: bool = True
    point_distance_factor: bool = True
    prior_factor: bool = False
    marginalization_factor: bool = True
    # estimator consume cadence: clouds every odom_io-th sweep
    # (odometry_node.cc:50 io_ratio / `odom_io` yaml)
    odom_io: int = 2
    enable_deskew: bool = True
    cutoff_deskew: bool = False
    # newest-frame mini-GN association rounds accumulate into the factor
    # set (Estimator.cc:978; indoor profile sets it)
    keep_features: bool = True
    msg_time_delay: float = 0.05
    # compile-time variants of the reference (Estimator.h:55-56): corner
    # features in the local map + factors, and frozen linearization points
    # for the local-map build
    use_corner: bool = False
    fix_map: bool = False
    # CalculateLaserOdom GN budget for the newest frame when the IMU
    # factor is on (Estimator.cc:1561 routes it to the mini-GN in that
    # case). Default = the reference's num_max_iterations_ = 10 with the
    # same 0.05deg/0.05cm early abort: on the 89-sweep synthetic indoor
    # CLI sequence the full budget buys 0.264 -> 0.176 m ATE for ~4%
    # throughput (109.3 -> 104.8 f/s on a v5e); each iteration is one
    # serial KNN+fit association round.
    newest_refine_iters: int = 10

    imu: ImuConfig = field(default_factory=ImuConfig)

    # solver
    max_solver_iterations: int = 10
    # LM function_tolerance. Ceres's default is 1e-6, but in f32 the
    # window cost's relative per-iteration drops bottom out at ~1e-3
    # (measured), so 1e-6 never fires and the LM silently burns its full
    # iteration budget every sweep. 5e-3 exits once the improvement falls
    # under 0.5% — the window re-solves every sweep from a warm start, so
    # the residual polish is recovered next sweep (A/B'd: ATE unchanged,
    # see README perf table).
    solver_ftol: float = 5e-3
    cauchy_loss_scale: float = 1.0
    convergence_cost_pim_th: float = 1e3  # turn-off gate (Estimator.cc:1935)
    convergence_marg_ratio_th: float = 2.0

    # --- TPU capacities ---
    surf_stack_cap: int = 6144        # per-frame downsampled surf stack
    corner_stack_cap: int = 2048
    local_map_cap: int = 49152        # merged local map before filtering
    local_map_filtered_cap: int = 24576
    local_map_corner_cap: int = 12288  # filtered corner local map (use_corner)
    features_per_frame_cap: int = 4096

    @property
    def corner_state_cap(self) -> int:
        """Window corner-stack capacity: collapsed to 1 when corners are
        disabled so the state pytree carries no dead weight."""
        return self.corner_stack_cap if self.use_corner else 1

    @property
    def pivot_idx(self) -> int:
        return self.window_size - self.opt_window_size


@dataclass(frozen=True)
class LioConfig:
    """Full-pipeline configuration bundle."""

    sensor: SensorConfig = field(default_factory=SensorConfig)
    feature: FeatureConfig = field(default_factory=FeatureConfig)
    odometry: OdometryConfig = field(default_factory=OdometryConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    estimator: EstimatorConfig = field(default_factory=EstimatorConfig)

    @staticmethod
    def indoor() -> "LioConfig":
        """config/indoor_test_config.yaml."""
        return LioConfig()

    @staticmethod
    def outdoor() -> "LioConfig":
        """config/outdoor_test_config.yaml."""
        return LioConfig(
            estimator=dataclasses.replace(
                EstimatorConfig(),
                window_size=7,
                opt_window_size=5,
                init_window_factor=1,
                estimate_extrinsic=1,
                extrinsic_translation=(-2.4, 0.0, 0.7),
                odom_io=3,
                keep_features=False,
                imu=ImuConfig(g_norm=9.80),
            ),
            odometry=dataclasses.replace(OdometryConfig(), io_ratio=3),
        )

    @staticmethod
    def outdoor_64() -> "LioConfig":
        """config/outdoor_test_config_64.yaml (KITTI 64-beam)."""
        return LioConfig(
            sensor=SensorConfig.hdl64(),
            estimator=dataclasses.replace(
                EstimatorConfig(),
                window_size=7,
                opt_window_size=5,
                init_window_factor=1,
                estimate_extrinsic=1,
                extrinsic_rotation=(
                    9.999976e-01, 7.553071e-04, -2.035826e-03,
                    -7.854027e-04, 9.998898e-01, -1.482298e-02,
                    2.024406e-03, 1.482454e-02, 9.998881e-01,
                ),
                extrinsic_translation=(-8.086759e-01, 3.195559e-01, -7.997231e-01),
                prior_factor=True,
                cutoff_deskew=True,
                msg_time_delay=0.0,
                odom_io=3,
                keep_features=False,
                imu=ImuConfig(g_norm=9.80),
                surf_stack_cap=8192,
                corner_stack_cap=4096,
                local_map_cap=65536,
                local_map_filtered_cap=32768,
                features_per_frame_cap=6144,
            ),
            odometry=dataclasses.replace(OdometryConfig(), io_ratio=3),
        )

    def extrinsic_lb(self):
        """Initial laser->body transform (q_lb [w,x,y,z], t_lb) as float64
        CPU tensors; callers cast and move them."""
        import torch

        from .utils import quaternion as quat

        r = np.array(self.estimator.extrinsic_rotation, dtype=np.float64).reshape(3, 3)
        q = quat.from_matrix(torch.as_tensor(r))
        t = torch.as_tensor(np.array(self.estimator.extrinsic_translation, dtype=np.float64))
        return q, t


def load_yaml(path: str) -> LioConfig:
    """Load a LioConfig from a simple YAML profile (configs/*.yaml)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)

    # YAML sequences arrive as lists; config fields must be hashable
    # tuples (LioConfig is a static jit argument)
    def tuplify(x):
        if isinstance(x, list):
            return tuple(tuplify(v) for v in x)
        if isinstance(x, dict):
            return {k: tuplify(v) for k, v in x.items()}
        return x

    raw = tuplify(raw)
    base = LioConfig()
    sensor = dataclasses.replace(base.sensor, **raw.get("sensor", {}))
    feature = dataclasses.replace(base.feature, **raw.get("feature", {}))
    odometry = dataclasses.replace(base.odometry, **raw.get("odometry", {}))
    mapping = dataclasses.replace(base.mapping, **raw.get("mapping", {}))
    est_raw = dict(raw.get("estimator", {}))
    imu = dataclasses.replace(base.estimator.imu, **est_raw.pop("imu", {}))
    estimator = dataclasses.replace(base.estimator, imu=imu, **est_raw)
    return LioConfig(sensor=sensor, feature=feature, odometry=odometry, mapping=mapping, estimator=estimator)
