"""Typed config tree mirroring the reference stack's ROS parameter names.

The port's own copy of ``dddmr_navigation_tpu/config/schema.py``, kept
equal to it field for field and default for default (the tests compare
the two), so that the port imports nothing of the JAX package.

Field names intentionally match the YAML keys of the reference's canonical
deployment config (`dddmr_p2p_move_base/config/p2p_move_base_localization.yaml`)
so reference YAMLs can be ingested directly via :func:`load_yaml_config`.

TPU-specific *static shape* knobs (rollout counts, padded plan length, voxel
window dims, …) live in the same dataclasses but are prefixed with no ROS
analogue; they are compile-time constants — changing them retriggers jit.

All dataclasses are frozen (hashable) so they can be passed as jit static
arguments.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _f(**kw):
    return field(default_factory=lambda: kw)


@dataclass(frozen=True)
class CuboidConfig:
    """Robot footprint as an 8-corner cuboid in base frame.

    Corner naming follows the reference (`trajectory_generators` YAML):
    f/b front/back, l/r left/right, b/t bottom/top. See :meth:`corners`
    for the storage order the collision critic depends on.
    """
    flb: Tuple[float, float, float] = (0.42, 0.36, 0.0)
    frb: Tuple[float, float, float] = (0.42, -0.36, 0.0)
    flt: Tuple[float, float, float] = (0.42, 0.36, 0.6)
    frt: Tuple[float, float, float] = (0.42, -0.36, 0.6)
    blb: Tuple[float, float, float] = (-0.35, 0.36, 0.0)
    brb: Tuple[float, float, float] = (-0.35, -0.36, 0.0)
    blt: Tuple[float, float, float] = (-0.35, 0.36, 0.6)
    brt: Tuple[float, float, float] = (-0.35, -0.36, 0.6)

    def corners(self):
        """8x3 corner list in the reference's *storage* order
        (`dd_simple_trajectory_generator_theory.cpp:213-229`):
        [0]=blb, [1]=brb, [2]=blt, [3]=flb, [4]=brt, [5]=frt, [6]=flt,
        [7]=frb. The collision critic derives its oriented-box axes as
        dx=c[3]-c[0], dy=c[1]-c[0], dz=c[2]-c[0]
        (`collision_model.cpp:100-115`), so this order is load-bearing.
        """
        return [self.blb, self.brb, self.blt, self.flb,
                self.brt, self.frt, self.flt, self.frb]


@dataclass(frozen=True)
class TrajectoryGeneratorLimits:
    """Kinematic/dynamic limits (reference `differential_drive_simple` keys)."""
    max_vel_x: float = 1.0
    min_vel_x: float = 0.1
    max_vel_theta: float = 0.6
    min_vel_theta: float = 0.15
    acc_lim_x: float = 1.0
    acc_lim_theta: float = 3.0
    deceleration_ratio: float = 2.0
    use_motor_constraint: bool = True
    max_motor_shaft_rpm: float = 3000.0
    wheel_diameter: float = 0.16
    gear_ratio: float = 1.0
    robot_radius: float = 0.25
    # omni-drive only (reference OmniSimpleTrajectoryGeneratorTheory keys,
    # `p2p_wo_mcl.yaml:86-98`)
    max_vel_y: float = 0.0
    min_vel_y: float = 0.0
    acc_lim_y: float = 1.0
    min_vel_trans: float = 0.1
    max_vel_trans: float = 1.0


@dataclass(frozen=True)
class DDSimpleGeneratorConfig:
    """Diff-drive DWA sampler (reference DDSimpleTrajectoryGeneratorTheory)."""
    limits: TrajectoryGeneratorLimits = TrajectoryGeneratorLimits()
    controller_frequency: float = 10.0
    sim_time: float = 2.0
    linear_x_sample: int = 5
    angular_z_sample: int = 10
    sim_granularity: float = 0.05
    angular_sim_granularity: float = 0.025
    cuboid: CuboidConfig = CuboidConfig()
    # --- TPU static shapes ---
    max_num_steps: int = 64   # pad per-sample variable num_steps up to this

    @property
    def n_samples_padded(self) -> int:
        # +1 slot per axis for the VelocityIterator zero-insertion
        return (self.linear_x_sample + 1) * (self.angular_z_sample + 1)


@dataclass(frozen=True)
class OmniSimpleGeneratorConfig:
    """Omni-drive DWA sampler (reference OmniSimpleTrajectoryGeneratorTheory,
    `omni_simple_trajectory_generator_theory.cpp:259-332`): vx × vy × ω grid."""
    limits: TrajectoryGeneratorLimits = TrajectoryGeneratorLimits(
        min_vel_x=-1.0, max_vel_y=1.0, min_vel_y=-1.0, acc_lim_x=2.0,
        acc_lim_y=2.0, use_motor_constraint=False)
    controller_frequency: float = 10.0
    sim_time: float = 2.0
    linear_x_sample: int = 5
    linear_y_sample: int = 5
    angular_z_sample: int = 10
    sim_granularity: float = 0.05
    angular_sim_granularity: float = 0.025
    cuboid: CuboidConfig = CuboidConfig()
    max_num_steps: int = 64

    @property
    def n_samples_padded(self) -> int:
        return ((self.linear_x_sample + 1) * (self.linear_y_sample + 1)
                * (self.angular_z_sample + 1))


@dataclass(frozen=True)
class DDRotateInplaceConfig:
    """Rotate-in-place generator (reference DDRotateInplaceTheory)."""
    controller_frequency: float = 10.0
    rotation_speed: float = 0.5
    cuboid: CuboidConfig = CuboidConfig()
    max_num_steps: int = 256  # full revolution at fine granularity
    sim_granularity: float = 0.05
    angular_sim_granularity: float = 0.025


@dataclass(frozen=True)
class CriticConfig:
    """One critic binding (reference mpc_critics plugin entries)."""
    plugin: str = "mpc_critics::CollisionModel"
    weight: float = 1.0
    translation_weight: float = 1.0   # PurePursuitModel only
    orientation_weight: float = 0.01  # PurePursuitModel only


@dataclass(frozen=True)
class CriticsConfig:
    """Critic stack bound to one generator, in scoring order
    (reference `stacked_scoring_model.cpp:75-97`: negative short-circuits)."""
    collision: Optional[CriticConfig] = CriticConfig(plugin="mpc_critics::CollisionModel", weight=1.0)
    collision_min_max: Optional[CriticConfig] = None  # mpc_critics::CollisionMinMaxModel
    stick_path: Optional[CriticConfig] = CriticConfig(plugin="mpc_critics::StickPathModel", weight=0.1)
    pure_pursuit: Optional[CriticConfig] = CriticConfig(
        plugin="mpc_critics::PurePursuitModel", translation_weight=1.0, orientation_weight=0.01)
    toward_global_plan: Optional[CriticConfig] = CriticConfig(
        plugin="mpc_critics::TowardGlobalPlanModel", weight=1.0)
    shortest_angle: Optional[CriticConfig] = None
    twirling: Optional[CriticConfig] = None


@dataclass(frozen=True)
class LocalPlannerConfig:
    """Reference `local_planner` node params + TPU shapes."""
    forward_prune: float = 3.0
    backward_prune: float = 1.0
    heading_tracking_distance: float = 0.5
    heading_align_angle: float = 0.5
    prune_plane_timeout: float = 3.0
    xy_goal_tolerance: float = 0.3
    yaw_goal_tolerance: float = 0.3
    controller_frequency: float = 10.0
    cuboid: CuboidConfig = CuboidConfig()
    generator: DDSimpleGeneratorConfig = DDSimpleGeneratorConfig()
    omni_generator: OmniSimpleGeneratorConfig = OmniSimpleGeneratorConfig()
    rotate_generator: DDRotateInplaceConfig = DDRotateInplaceConfig()
    critics: CriticsConfig = CriticsConfig()
    rotate_critics: CriticsConfig = CriticsConfig(
        collision=CriticConfig(plugin="mpc_critics::CollisionModel", weight=1.0),
        stick_path=None, pure_pursuit=None, toward_global_plan=None,
        shortest_angle=CriticConfig(plugin="mpc_critics::ShortestAngleModel", weight=1.0),
    )
    # --- TPU static shapes ---
    max_plan_len: int = 512       # padded global-plan pose count
    max_prune_len: int = 128      # padded prune-plan pose count
    max_obstacle_points: int = 2048  # padded aggregated-observation size
    # collision critic obstacle chunk: bounds the (B,S,N,3,chunk)
    # intermediate; lower it for large robot batches / sample grids
    collision_obstacle_chunk: int = 256
    # nearest-K obstacle pre-prune for the collision critic (0 = off);
    # exact whenever ≤ K obstacles lie within the rollout sweep's reach
    collision_near_k: int = 0
    # collision sweep backend: xla | auto (Pallas on TPU) |
    # pallas | pallas_interpret (ops/collision.py)
    collision_backend: str = "xla"


@dataclass(frozen=True)
class StaticLayerConfig:
    """Reference `perception_3d::StaticLayer` params."""
    use_adaptive_connection: bool = False
    adaptive_connection_number: int = 20
    radius_of_ground_connection: float = 1.5
    intensity_search_radius: float = 1.0
    intensity_search_punish_weight: float = 0.1
    static_imposing_radius: float = 1.5
    enable_edge_detection: bool = True
    # TPU static shapes
    max_ground_neighbors: int = 16   # K for the kNN ground graph


@dataclass(frozen=True)
class SpinningLidarConfig:
    """Reference `perception_3d::MultiLayerSpinningLidar` params."""
    vertical_FOV_top: float = 15.0
    vertical_FOV_bottom: float = -15.0
    scan_effective_positive_start: float = 30.0
    scan_effective_positive_end: float = 180.0
    scan_effective_negative_start: float = -30.0
    scan_effective_negative_end: float = -180.0
    xy_resolution: float = 0.05
    height_resolution: float = 0.05
    marking_height: float = 2.0
    perception_window_size: float = 3.0
    segmentation_ignore_ratio: float = 0.5
    expected_sensor_time: float = 0.2
    euclidean_cluster_extraction_tolerance: float = 0.1
    euclidean_cluster_extraction_min_cluster_size: int = 1
    stitcher_num: int = 0     # accumulate last N sweeps (0 = off)
    # TPU static shapes
    max_scan_points: int = 8192
    range_image_rows: int = 16
    range_image_cols: int = 360


@dataclass(frozen=True)
class PerceptionConfig:
    """Reference `perception_3d` node params (GlobalUtils inflation block)."""
    global_frame: str = "map"
    robot_base_frame: str = "base_link"
    max_obstacle_distance: float = 9999.0
    inscribed_radius: float = 0.5
    inflation_descending_rate: float = 2.0
    inflation_radius: float = 1.5
    sensors_collected_frequency: float = 10.0
    static_layer: StaticLayerConfig = StaticLayerConfig()
    lidar: SpinningLidarConfig = SpinningLidarConfig()
    path_blocked_check_radius: float = 0.3
    # TPU static shapes
    max_marked_voxels: int = 2048  # padded active-marking set per tick
    # padded near-window ground-node budget for the dGraph recompute
    # (size to the nodes inside the marking window + inflation_radius;
    # the default is generous for real maps, small fleets can shrink it)
    max_window_nodes: int = 8192
    # clustering pool factor (see MarkingParams.cluster_pool: 2 at a
    # 0.05 m grid = the reference's own 0.1 m clustering lattice)
    cluster_pool: int = 1
    # Voxel window: dense robot-centric occupancy grid (cells per side derived
    # from perception_window_size and xy_resolution at trace time).
    voxel_window_cells_xy: int = 128
    voxel_window_cells_z: int = 44


@dataclass(frozen=True)
class GlobalPlannerConfig:
    """Reference `global_planner` node params + TPU shapes."""
    turning_weight: float = 0.1
    a_star_expanding_radius: float = 0.5
    # TPU static shapes
    max_path_len: int = 512        # padded node-path length
    max_relax_iters: int = 1024    # wavefront relaxation bound
    interpolation_step: float = 0.05  # getROSPath pose interpolation
    max_long_edges: int = 4096     # LOS-verified long-edge budget
    los_samples: int = 32          # per-edge LOS sample count
    max_lethal_points: int = 2048  # aggregated lethal cloud padding
    turning_dir_bins: int = 16     # incoming-direction bins (w_turn > 0)
    # Per-TICK relaxation budget (0 = run to convergence in one tick —
    # classic behavior). With a budget, a fresh goal's cold solve is
    # AMORTIZED across control ticks: each tick relaxes at most this many
    # iterations and carries the partial field; the plan stays empty (FSM
    # in d_planning, the reference's behavior while its 5 Hz GetPlan
    # thread works — `p2p_global_plan_manager.cpp:108-132`) until the
    # field reaches the robot, so no single tick ever pays the whole
    # solve. Warm ticks are unaffected (they converge within any sane
    # budget).
    relax_iters_per_tick: int = 0


@dataclass(frozen=True)
class DWAGlobalPlannerConfig:
    look_ahead_distance: float = 2.0
    recompute_frequency: float = 10.0


@dataclass(frozen=True)
class MoveBaseConfig:
    """Reference `p2p_move_base` FSM params."""
    controller_frequency: float = 10.0
    # which GetPlan action the plan manager queries
    # (`p2p_global_plan_manager.cpp:45-47`): "get_dwa_plan" = cached path +
    # windowed replans; "get_plan" = full replan every query.
    global_planner_action_name: str = "get_dwa_plan"
    planner_patience: float = 10.0
    oscillation_distance: float = 5.0
    oscillation_angle: float = 1.0
    oscillation_patience: float = 15.0
    controller_patience: float = 10.0
    no_plan_retry_num: int = 10
    waiting_patience: float = 10.0
    global_plan_query_frequency: float = 5.0


@dataclass(frozen=True)
class MCLConfig:
    """Reference `mcl_3dl` params."""
    num_particles: int = 60
    # EDT sampling for the measurement model: "trilinear" (default,
    # 8-corner interpolation), "nearest" (1 gather per particle×point), or
    # "corr" (correspondence-cached: 1 gather per point, shared across
    # particles, point-to-plane distances to the cached Voronoi owner
    # — the fleet-scale tracking mode; see likelihood.measure_all_corr)
    field_sampling: str = "trilinear"
    # 'corr' mode: free-slide radius of a cached owner's local surface
    # patch, in field-resolution units (likelihood.measure_all_corr)
    corr_patch_cells: float = 2.0
    init_var_x: float = 2.0
    init_var_y: float = 2.0
    init_var_z: float = 0.5
    init_var_roll: float = 0.1
    init_var_pitch: float = 0.1
    init_var_yaw: float = 0.5
    resample_var_x: float = 0.2
    resample_var_y: float = 0.2
    resample_var_z: float = 0.2
    resample_var_roll: float = 0.2
    resample_var_pitch: float = 0.2
    resample_var_yaw: float = 0.1
    expansion_var_x: float = 0.5
    expansion_var_y: float = 0.5
    expansion_var_z: float = 0.5
    expansion_var_roll: float = 0.2
    expansion_var_pitch: float = 0.2
    expansion_var_yaw: float = 0.2
    match_ratio_thresh: float = 0.0
    update_min_d: float = 0.1
    update_min_a: float = 0.1
    odom_err_lin_lin: float = 0.6
    odom_err_lin_ang: float = 0.3
    odom_err_ang_lin: float = 0.3
    odom_err_ang_ang: float = 0.6
    odom_err_integ_lin_tc: float = 5.0
    odom_err_integ_ang_tc: float = 10.0
    lpf_step: float = 2.0
    jump_dist: float = 1.0
    jump_ang: float = 1.57
    bias_var_dist: float = 2.0
    bias_var_ang: float = 1.57
    match_dist_min: float = 0.3
    match_dist_flat: float = 0.05
    threshold_for_trusted_ground: int = 6
    radius_of_ground_search: float = 1.0
    # feature preprocessing (`cbLeGoFeatureCloud`, `mcl_3dl.cpp:300-443`)
    euc_cluster_distance: float = 0.8
    euc_cluster_min_size: int = 3
    # TPU static shapes
    max_feature_points: int = 1024


@dataclass(frozen=True)
class SlamConfig:
    """Reference `lego_loam` params (canonical values:
    `lego_loam_bor/config/loam_c16_config.yaml`)."""
    # laser / projection (lego_loam_ip)
    num_vertical_scans: int = 16
    num_horizontal_scans: int = 1000
    ground_scan_index: int = 7
    vertical_angle_bottom: float = -15.0
    vertical_angle_top: float = 15.0
    scan_period: float = 0.1
    segment_valid_point_num: int = 5
    segment_valid_line_num: int = 2
    segment_theta: float = 60.0          # degrees
    maximum_detection_range: float = 120.0
    distance_for_patch_between_rings: float = 1.0
    sensor_mount_angle: float = 0.0
    ground_angle_threshold: float = 10.0  # imageProjection.cpp ground test
    # feature association (lego_loam_fa)
    edge_threshold: float = 0.1
    surf_threshold: float = 0.1
    nearest_feature_search_distance: float = 3.0
    # mapping (lego_loam_mo)
    distance_between_key_frame: float = 1.0
    angle_between_key_frame: float = 1.0
    enable_loop_closure: bool = True
    surrounding_keyframe_search_num: int = 10
    history_keyframe_search_radius: float = 15.0
    history_keyframe_search_num: int = 5
    history_keyframe_fitness_score: float = 0.5
    ground_voxel_size: float = 0.4
    # TPU static shapes
    max_sharp: int = 64          # 2/sector × 6 sectors × 16 rings = 192 cap
    max_less_sharp: int = 512
    max_flat: int = 256
    max_less_flat: int = 2048
    max_keyframes: int = 256
    max_edges: int = 512
    scan_match_iters: int = 12
    icp_iters: int = 30
    pose_graph_iters: int = 8
    # scan-to-map refinement vs the accumulated surrounding-keyframe
    # submap (`mapOptimization.cpp:1192-1780`); ≤1 disables (scan-to-last-
    # keyframe only). Leaves mirror downSizeFilterCorner/Surf.
    map_match_iters: int = 6
    submap_corner_leaf: float = 0.2
    submap_surf_leaf: float = 0.4
    submap_sharp_pad: int = 2048
    submap_flat_pad: int = 4096


@dataclass(frozen=True)
class NavigationConfig:
    """Top-level config for one navigation vertical."""
    move_base: MoveBaseConfig = MoveBaseConfig()
    local_planner: LocalPlannerConfig = LocalPlannerConfig()
    perception: PerceptionConfig = PerceptionConfig()
    global_planner: GlobalPlannerConfig = GlobalPlannerConfig()
    dwa_global_planner: DWAGlobalPlannerConfig = DWAGlobalPlannerConfig()
    mcl: MCLConfig = MCLConfig()
    slam: SlamConfig = SlamConfig()


# ---------------------------------------------------------------------------
# YAML ingestion (reference deployment YAMLs)
# ---------------------------------------------------------------------------

def _get(d, *keys, default=None):
    for k in keys:
        if not isinstance(d, dict) or k not in d:
            return default
        d = d[k]
    return d


def _cuboid_from_yaml(c: dict) -> CuboidConfig:
    if not c:
        return CuboidConfig()
    kw = {k: tuple(v) for k, v in c.items() if k in
          ("flb", "frb", "flt", "frt", "blb", "brb", "blt", "brt")}
    return CuboidConfig(**kw)


def load_yaml_config(path: str) -> NavigationConfig:
    """Ingest a reference-format deployment YAML (ROS 2 param layout:
    ``node: {ros__parameters: {...}}``) into a :class:`NavigationConfig`.

    Unknown keys are ignored; missing keys keep the reference defaults.
    """
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)

    def params(node):
        return _get(doc, node, "ros__parameters", default={}) or {}

    mb = params("p2p_move_base")
    gpm = params("global_plan_manager")
    lp = params("local_planner")
    tg = params("trajectory_generators")
    mc = params("mpc_critics")
    p3l = params("perception_3d_local")
    gp = params("global_planner")
    dwa = params("dynamic_window_aware_global_planner")
    mcl = params("mcl_3dl")

    dds = _get(tg, "differential_drive_simple", default={}) or {}
    limits = TrajectoryGeneratorLimits(**{
        k: dds[k] for k in (
            "max_vel_x", "min_vel_x", "max_vel_theta", "min_vel_theta",
            "acc_lim_x", "acc_lim_theta", "deceleration_ratio",
            "max_motor_shaft_rpm", "wheel_diameter", "gear_ratio",
            "robot_radius") if k in dds})
    gen = DDSimpleGeneratorConfig(
        limits=limits,
        controller_frequency=dds.get("controller_frequency", 10.0),
        sim_time=dds.get("sim_time", 2.0),
        linear_x_sample=int(dds.get("linear_x_sample", 5)),
        angular_z_sample=int(dds.get("angular_z_sample", 10)),
        sim_granularity=dds.get("sim_granularity", 0.05),
        angular_sim_granularity=dds.get("angular_sim_granularity", 0.025),
        cuboid=_cuboid_from_yaml(dds.get("cuboid")),
    )

    rot = _get(tg, "differential_drive_rotate_inplace", default={}) or {}
    rot_gen = DDRotateInplaceConfig(
        controller_frequency=rot.get("controller_frequency", 10.0),
        rotation_speed=rot.get("rotation_speed", 0.5),
        cuboid=_cuboid_from_yaml(rot.get("cuboid")),
    )

    def critic(name, default_w=1.0):
        c = _get(mc, name, default={})
        if not c:
            return None
        return CriticConfig(
            plugin=c.get("plugin", ""), weight=c.get("weight", default_w),
            translation_weight=c.get("translation_weight", 1.0),
            orientation_weight=c.get("orientation_weight", 0.01))

    critics = CriticsConfig(
        collision=critic("collision"),
        stick_path=critic("stick_path", 0.1),
        pure_pursuit=critic("pure_pursuit"),
        toward_global_plan=critic("toward_global_plan"),
        twirling=critic("twirling"),
    )

    # omni deployment (p2p_wo_mcl.yaml:86-115 binds omni_drive_simple)
    omni = _get(tg, "omni_drive_simple", default={}) or {}
    omni_limits = TrajectoryGeneratorLimits(**{
        **{k: omni[k] for k in (
            "max_vel_x", "min_vel_x", "max_vel_y", "min_vel_y",
            "max_vel_theta", "min_vel_theta", "min_vel_trans",
            "max_vel_trans", "acc_lim_x", "acc_lim_y", "acc_lim_theta",
            "deceleration_ratio", "use_motor_constraint") if k in omni}})
    omni_gen = OmniSimpleGeneratorConfig(
        limits=omni_limits,
        controller_frequency=omni.get("controller_frequency", 10.0),
        sim_time=omni.get("sim_time", 2.0),
        linear_x_sample=int(omni.get("linear_x_sample", 5)),
        linear_y_sample=int(omni.get("linear_y_sample", 5)),
        angular_z_sample=int(omni.get("angular_z_sample", 10)),
        sim_granularity=omni.get("sim_granularity", 0.05),
        angular_sim_granularity=omni.get("angular_sim_granularity", 0.025),
        cuboid=_cuboid_from_yaml(omni.get("cuboid")),
    ) if omni else OmniSimpleGeneratorConfig()

    lidar_y = _get(p3l, "lidar", default={}) or {}
    lidar = SpinningLidarConfig(**{
        k: lidar_y[k] for k in (
            "vertical_FOV_top", "vertical_FOV_bottom",
            "scan_effective_positive_start", "scan_effective_positive_end",
            "scan_effective_negative_start", "scan_effective_negative_end",
            "height_resolution", "marking_height", "perception_window_size",
            "segmentation_ignore_ratio", "expected_sensor_time",
            "stitcher_num")
        if k in lidar_y},
        xy_resolution=lidar_y.get("xy_resolution", lidar_y.get("resolution", 0.05)),
    )

    perception = PerceptionConfig(
        global_frame=p3l.get("global_frame", "map"),
        robot_base_frame=p3l.get("robot_base_frame", "base_link"),
        max_obstacle_distance=p3l.get("max_obstacle_distance", 9999.0),
        inscribed_radius=p3l.get("inscribed_radius", 0.5),
        inflation_descending_rate=p3l.get("inflation_descending_rate", 2.0),
        inflation_radius=p3l.get("inflation_radius", 1.5),
        sensors_collected_frequency=p3l.get("sensors_collected_frequency", 10.0),
        lidar=lidar,
        path_blocked_check_radius=_get(p3l, "path_blocked_strategy", "check_radius", default=0.3),
    )

    local = LocalPlannerConfig(
        forward_prune=lp.get("forward_prune", 3.0),
        backward_prune=lp.get("backward_prune", 1.0),
        heading_tracking_distance=lp.get("heading_tracking_distance", 0.5),
        heading_align_angle=lp.get("heading_align_angle", 0.5),
        prune_plane_timeout=lp.get("prune_plane_timeout", 3.0),
        xy_goal_tolerance=lp.get("xy_goal_tolerance", 0.3),
        yaw_goal_tolerance=lp.get("yaw_goal_tolerance", 0.3),
        controller_frequency=lp.get("controller_frequency", 10.0),
        cuboid=_cuboid_from_yaml(lp.get("cuboid")),
        generator=gen,
        omni_generator=omni_gen,
        rotate_generator=rot_gen,
        critics=critics,
    )

    move_base = MoveBaseConfig(
        controller_frequency=mb.get("controller_frequency", 10.0),
        planner_patience=mb.get("planner_patience", 10.0),
        oscillation_distance=mb.get("oscillation_distance", 5.0),
        oscillation_angle=mb.get("oscillation_angle", 1.0),
        oscillation_patience=mb.get("oscillation_patience", 15.0),
        controller_patience=mb.get("controller_patience", 10.0),
        no_plan_retry_num=int(mb.get("no_plan_retry_num", 10)),
        waiting_patience=mb.get("waiting_patience", 10.0),
        global_plan_query_frequency=gpm.get("global_plan_query_frequency", 5.0),
        global_planner_action_name=gpm.get("global_planner_action_name",
                                           "get_dwa_plan"),
    )

    gplanner = GlobalPlannerConfig(
        turning_weight=gp.get("turning_weight", 0.1),
        a_star_expanding_radius=gp.get("a_star_expanding_radius", 0.5),
    )
    dwa_cfg = DWAGlobalPlannerConfig(
        look_ahead_distance=dwa.get("look_ahead_distance", 2.0),
        recompute_frequency=dwa.get("recompute_frequency", 10.0),
    )

    mcl_kw = {k: mcl[k] for k in MCLConfig.__dataclass_fields__ if k in mcl}
    if "num_particles" in mcl_kw:
        mcl_kw["num_particles"] = int(mcl_kw["num_particles"])
    lik = mcl.get("likelihood", {}) or {}
    for k in ("match_dist_min", "match_dist_flat", "threshold_for_trusted_ground",
              "radius_of_ground_search"):
        if k in lik:
            mcl_kw[k] = lik[k]
    mcl_cfg = MCLConfig(**mcl_kw)

    return NavigationConfig(
        move_base=move_base, local_planner=local, perception=perception,
        global_planner=gplanner, dwa_global_planner=dwa_cfg, mcl=mcl_cfg)


def load_slam_yaml(path: str) -> SlamConfig:
    """Ingest a reference lego_loam config (e.g.
    `lego_loam_bor/config/loam_c16_config.yaml`: `lego_loam_ip` /
    `lego_loam_fa` / `lego_loam_mo` node sections)."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)

    ip = _get(doc, "lego_loam_ip", "ros__parameters", default={}) or {}
    fa = _get(doc, "lego_loam_fa", "ros__parameters", default={}) or {}
    mo = _get(doc, "lego_loam_mo", "ros__parameters", default={}) or {}

    kw = {}
    laser = ip.get("laser", {}) or {}
    for k in ("num_vertical_scans", "num_horizontal_scans",
              "ground_scan_index", "vertical_angle_bottom",
              "vertical_angle_top", "scan_period"):
        if k in laser:
            kw[k] = laser[k]
    proj = ip.get("imageProjection", {}) or {}
    for k in ("segment_valid_point_num", "segment_valid_line_num",
              "segment_theta", "maximum_detection_range",
              "distance_for_patch_between_rings"):
        if k in proj:
            kw[k] = proj[k]
    feat = fa.get("featureAssociation", {}) or {}
    for k in ("edge_threshold", "surf_threshold",
              "nearest_feature_search_distance"):
        if k in feat:
            kw[k] = feat[k]
    mapping = mo.get("mapping", {}) or {}
    for k in ("distance_between_key_frame", "angle_between_key_frame",
              "enable_loop_closure", "surrounding_keyframe_search_num",
              "history_keyframe_search_radius", "history_keyframe_search_num",
              "history_keyframe_fitness_score", "ground_voxel_size"):
        if k in mapping:
            kw[k] = mapping[k]
    for k in ("num_vertical_scans", "num_horizontal_scans",
              "ground_scan_index", "segment_valid_point_num",
              "segment_valid_line_num", "surrounding_keyframe_search_num",
              "history_keyframe_search_num"):
        if k in kw:
            kw[k] = int(kw[k])
    return SlamConfig(**kw)
