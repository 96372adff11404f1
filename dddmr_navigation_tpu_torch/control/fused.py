"""The fused perception → global replan → local tick, batched over robots.

Counterpart of ``dddmr_navigation_tpu/control/fused.py``: each stage
consumes the previous stage's output on the device,

    scan ─ mark/clear ─→ dGraph ─ min-compose ─→ composed field
        ├─ lethal cloud ─→ long-edge LOS gate ─┐
        └────────────────→ wavefront relax ────┴→ path extract
        → pose interpolation (getROSPath) → prune → rollouts
        → critics (against this scan's own observation) → argmin → cmd_vel

The map tables (graph, ``MapContext``, turning tables) are shared by all
robots; each robot has its own ``MarkingState`` and wavefront field. The
batched tick equals the JAX package's ``vmap(fused_tick)`` robot for robot.
The fleet tick of ``parallel/fleet.py`` runs the halves around one fleet
relaxation. With depth cameras each robot also keeps a depth layer (its own
grid, distance field and frame ring); the no-entry zone field min-composes
into the stack under its toggle, and the speed zones cap the sampler.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import numpy as np
import torch

from dddmr_navigation_tpu_torch.config import NavigationConfig
from dddmr_navigation_tpu_torch.geometry import (
    quat_rotate_fma, slope_aware_quat)
from dddmr_navigation_tpu_torch.ops.compaction import first_k_true_indices
from dddmr_navigation_tpu_torch.perception.voxel import VoxelSpec
from dddmr_navigation_tpu_torch.rounding import fma_norm, recip
from dddmr_navigation_tpu_torch.perception.fov import RangeImageSpec
from dddmr_navigation_tpu_torch.perception.static_map import (
    MapContext, build_map_context)
from dddmr_navigation_tpu_torch.perception.marking import (
    MarkingParams, MarkingState, init_marking_state, perception_update)
from dddmr_navigation_tpu_torch.perception.layers import (
    min_dgraph, no_entry_dgraph, speed_limit_at)
from dddmr_navigation_tpu_torch.perception.depth_camera import (
    CameraModel, DepthCameraBuffer, DepthCameraObservation,
    depth_layer_update, init_depth_buffer, push_observation)
from dddmr_navigation_tpu_torch.planning.global_.los import (
    lethal_cloud_from_dgraph)
from dddmr_navigation_tpu_torch.planning.global_.planner import (
    GlobalPathResult, PlanPrep, plan_prepare, plan_finish, relax)
from dddmr_navigation_tpu_torch.planning.global_.wavefront import (
    edge_azimuth, edge_bins, turning_penalty_table)
from dddmr_navigation_tpu_torch.planning.local.planner import (
    GlobalPlan, compute_velocity_command)
from dddmr_navigation_tpu_torch.planning.global_.graph import build_ground_graph
from dddmr_navigation_tpu_torch.runtime import tracing


class FusedMap(NamedTuple):
    """Per-map tensors shared by every robot."""
    map_ctx: MapContext
    ground: torch.Tensor          # (G, 3)
    ground_valid: torch.Tensor    # (G,)
    nbr_idx: torch.Tensor         # (G, K)
    nbr_dist: torch.Tensor        # (G, K)
    nbr_valid: torch.Tensor       # (G, K)
    avg_intensity: torch.Tensor   # (G,)
    node_weight: torch.Tensor     # (G,)
    static_dgraph: torch.Tensor   # (G,) static-layer field (overhang lethals)
    los_relevant: torch.Tensor    # (G,) nodes near a long edge
    # turning-planner geometry (None when turning_weight == 0)
    wf_az: Optional[torch.Tensor]     # (G, K) edge azimuths
    wf_bins: Optional[torch.Tensor]   # (G, K) int32 edge direction bins
    turn_pen: Optional[torch.Tensor]  # (G, K, K) w_turn·θ table
    # zone layers (None without zones): the no-entry distance field
    # (`no_entry_layer.cpp:225-290`) and the speed-zone cloud
    # (`speed_limit_layer.cpp:222-300`)
    no_entry_field: Optional[torch.Tensor] = None    # (G,)
    speed_zone_pts: Optional[torch.Tensor] = None    # (Z, 3)
    speed_zone_valid: Optional[torch.Tensor] = None  # (Z,)
    speed_zone_speed: Optional[torch.Tensor] = None  # (Z,)


class FusedState(NamedTuple):
    """Per-robot state carried from tick to tick, batched on axis 0."""
    marking: MarkingState
    wf_dist: torch.Tensor     # (B, G, bins) or (B, G) previous field
    wf_goal_idx: torch.Tensor  # (B,) goal node of that field, -1 for none
    wf_stall: torch.Tensor    # (B,) int32 budgeted-relaxation stall count
    # the depth-camera layer (None without cameras): its own marking state
    # and each robot's (C, N) frame ring
    depth_marking: Optional[MarkingState] = None
    depth_buffer: Optional[DepthCameraBuffer] = None


class FusedOut(NamedTuple):
    vx: torch.Tensor              # (B,)
    wz: torch.Tensor
    state: torch.Tensor           # PlannerState code
    best_cost: torch.Tensor
    plan: GlobalPlan              # this tick's interpolated global plan
    plan_ok: torch.Tensor         # global planner succeeded
    composed_dgraph: torch.Tensor  # (B, G)
    obs: torch.Tensor             # (B, k, 3) this tick's observation
    obs_mask: torch.Tensor        # (B, k)
    wf_iters: torch.Tensor        # (B,) int32 relaxation iterations
    best_index: torch.Tensor      # (B,) chosen rollout
    costs: torch.Tensor           # (B, S) rollout costs


def _specs(nav_cfg: NavigationConfig):
    p = nav_cfg.perception
    spec = VoxelSpec(
        nx=p.voxel_window_cells_xy, ny=p.voxel_window_cells_xy,
        nz=p.voxel_window_cells_z, xy_resolution=p.lidar.xy_resolution,
        height_resolution=p.lidar.height_resolution)
    ri_spec = RangeImageSpec(
        rows=p.lidar.range_image_rows, cols=p.lidar.range_image_cols,
        elev_min_deg=p.lidar.vertical_FOV_bottom,
        elev_max_deg=p.lidar.vertical_FOV_top)
    return spec, ri_spec, MarkingParams.from_config(p)


def build_fused_map(cfg: NavigationConfig, ground: np.ndarray,
                    map_pts: Optional[np.ndarray] = None,
                    node_weight: Optional[np.ndarray] = None,
                    static_dgraph: Optional[np.ndarray] = None,
                    intensity: Optional[np.ndarray] = None,
                    no_entry_zones=None, speed_zones=None,
                    device="cuda") -> FusedMap:
    """The kNN ground graph, map context and turning tables of one map
    (`GlobalPlannerRuntime`, `global_planner.cpp:156-176`), and the zone
    layers: ``no_entry_zones`` (Z, 3) points, ``speed_zones`` a pair of
    (Z, 3) points and (Z,) speeds."""
    ground = np.asarray(ground, np.float32)
    g = len(ground)
    graph = build_ground_graph(
        ground, radius=cfg.global_planner.a_star_expanding_radius,
        k_max=cfg.perception.static_layer.max_ground_neighbors,
        intensity=intensity)
    nw = (np.zeros(g, np.float32) if node_weight is None
          else np.asarray(node_weight, np.float32))
    sd = (np.full((g,), cfg.perception.max_obstacle_distance, np.float32)
          if static_dgraph is None else np.asarray(static_dgraph, np.float32))

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device)

    ground_t = t(ground)
    nbr_idx = t(graph.nbr_idx)
    gp = cfg.global_planner
    az = bins = tpen = None
    if gp.turning_weight > 0.0:
        az = edge_azimuth(ground_t, nbr_idx)
        bins = edge_bins(az, gp.turning_dir_bins)
        tpen = turning_penalty_table(nbr_idx, ground_t, gp.turning_weight)
    zones = {}
    if no_entry_zones is not None:
        zp = t(np.asarray(no_entry_zones, np.float32))
        zones["no_entry_field"] = no_entry_dgraph(
            ground_t, t(np.ones((g,), bool)), zp,
            t(np.ones((len(zp),), bool)),
            inflation_distance=cfg.perception.inflation_radius,
            max_obstacle_distance=cfg.perception.max_obstacle_distance)
    if speed_zones is not None:
        zpts, zspeed = speed_zones
        zones.update(speed_zone_pts=t(np.asarray(zpts, np.float32)),
                     speed_zone_valid=t(np.ones((len(zpts),), bool)),
                     speed_zone_speed=t(np.asarray(zspeed, np.float32)))
    return FusedMap(
        map_ctx=build_map_context(ground, map_pts, node_weight=node_weight,
                                  device=device),
        ground=ground_t, ground_valid=t(np.ones((g,), bool)),
        nbr_idx=nbr_idx, nbr_dist=t(graph.nbr_dist),
        nbr_valid=t(graph.nbr_valid), avg_intensity=t(graph.avg_intensity),
        node_weight=t(nw), static_dgraph=t(sd),
        los_relevant=t(los_relevant_mask(
            ground, graph, cfg.perception.inscribed_radius)),
        wf_az=az, wf_bins=bins, turn_pen=tpen, **zones)


def los_relevant_mask(ground: np.ndarray, graph,
                      inscribed_radius: float) -> np.ndarray:
    """(G,) bool: nodes within LOS reach (2×inscribed + 0.1 m) of at least
    one long edge (≥ 2×inscribed). Only those can sway an LOS verdict
    (`a_star_on_pc.cpp:168-198`), so the lethal cloud is drawn from them.
    Host-side numpy, once per map."""
    long_e = graph.nbr_valid & (graph.nbr_dist >= 2.0 * inscribed_radius)
    rel = np.zeros(len(ground), bool)
    src, kk = np.nonzero(long_e)
    if len(src) == 0:
        return rel
    p0 = ground[src]
    seg = ground[graph.nbr_idx[src, kk]] - p0
    reach2 = (2.0 * inscribed_radius + 0.1) ** 2
    seg_len2 = np.maximum(np.sum(seg * seg, axis=1), 1e-12)
    for s in range(0, len(p0), 256):                 # bounds the (G, e, 3)
        a, d, l2 = p0[s:s + 256], seg[s:s + 256], seg_len2[s:s + 256]
        w = ground[:, None, :] - a[None]
        t = np.clip(np.einsum("gej,ej->ge", w, d) / l2, 0.0, 1.0)
        closest = a[None] + t[..., None] * d[None]
        rel |= (np.sum((ground[:, None, :] - closest) ** 2, axis=-1)
                <= reach2).any(axis=1)
    return rel


def init_fused_state(cfg: NavigationConfig, num_ground_nodes: int,
                     robot_xyz, depth_cameras: int = 0,
                     depth_buffer_depth: int = 3,
                     depth_max_points: int = 512) -> FusedState:
    """Empty perception state at ``robot_xyz`` (B, 3) and no warm field;
    with ``depth_cameras`` an empty depth layer and frame rings too."""
    spec, _, params = _specs(cfg)
    gp = cfg.global_planner
    b = robot_xyz.shape[0]
    wf_shape = ((b, num_ground_nodes, gp.turning_dir_bins)
                if gp.turning_weight > 0.0 else (b, num_ground_nodes))
    dev = robot_xyz.device
    depth = {}
    if depth_cameras > 0:
        depth = dict(
            depth_marking=init_marking_state(spec, params, num_ground_nodes,
                                             robot_xyz),
            depth_buffer=init_depth_buffer(depth_cameras, depth_buffer_depth,
                                           depth_max_points, b, dev))
    return FusedState(
        marking=init_marking_state(spec, params, num_ground_nodes, robot_xyz),
        wf_dist=torch.full(wf_shape, torch.inf, device=dev),
        wf_goal_idx=torch.full((b,), -1, dtype=torch.int64, device=dev),
        wf_stall=torch.zeros((b,), dtype=torch.int32, device=dev), **depth)


def device_observation(scan_pts, scan_mask, k: int, leaf: float = 0.1):
    """Each robot's aggregated observation: one representative point per
    occupied ``leaf`` voxel of its valid scan (the first scan point in
    lexicographic voxel order), padded to ``k``. ``jnp.lexsort`` becomes
    stable sorts, last key first; its fixed-size ``nonzero`` the
    compaction. Returns ((B, k, 3), (B, k))."""
    b, n, _ = scan_pts.shape
    cells = torch.floor(scan_pts * recip(leaf)).int()
    cells = torch.where(scan_mask[..., None], cells, 2 ** 30)
    order = torch.arange(n, device=scan_pts.device).expand(b, n)
    for axis in (2, 1, 0):
        key = cells[..., axis].gather(1, order)
        order = order.gather(1, torch.sort(key, dim=1, stable=True).indices)
    sc = cells.gather(1, order[..., None].expand(-1, -1, 3))
    first = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                  device=scan_pts.device),
                       (sc[:, 1:] != sc[:, :-1]).any(dim=2)], dim=1)
    first = first & (sc[..., 0] != 2 ** 30)
    idx = first_k_true_indices(first, k)
    ok = idx >= 0
    src = order.gather(1, torch.clamp(idx, min=0))
    pts = scan_pts.gather(1, src[..., None].expand(-1, -1, 3))
    return torch.where(ok[..., None], pts, 0.0), ok


# getROSPath's interpolation fractions, the same f32 values as the host loop.
_INTERP_STEPS = np.arange(0.05, 0.99, 0.05, dtype=np.float32)


def interpolate_path_device(ground, res: GlobalPathResult, *,
                            max_plan_len: int, interp_steps: int = 19,
                            min_emit: float = 0.1) -> GlobalPlan:
    """`getROSPath` (`global_planner.cpp:313-391`) for each robot: node path
    → poses with slope-aware quats; per segment the interpolated
    candidates are emitted whenever they moved more than ``min_emit``
    from the last emitted pose; the ragged result is compacted by a
    cumsum scatter into ``max_plan_len`` slots."""
    b, L = res.node_ids.shape
    valid = res.node_valid
    ids = torch.clamp(res.node_ids, min=0)
    pts = ground[ids]                                            # (B, L, 3)
    slots = torch.arange(L, device=ids.device)
    has_next = valid & (slots < res.length[:, None] - 1)
    nxt_ids = ids[:, torch.clamp(slots + 1, max=L - 1)]
    nxt = torch.where(has_next[..., None], ground[nxt_ids], pts)
    v = nxt - pts
    quats = slope_aware_quat(v)                                  # (B, L, 4)

    last = pts
    emits, cands = [], []
    for s in _INTERP_STEPS[:interp_steps]:
        cand = pts + v * float(s)
        emit = fma_norm(cand - last) > min_emit
        last = torch.where(emit[..., None], cand, last)
        emits.append(emit)
        cands.append(cand)
    e = interp_steps + 1
    emit_all = torch.cat([valid[..., None],
                          torch.stack(emits, dim=2) & has_next[..., None]],
                         dim=2)                                  # (B, L, E)
    pos_all = torch.cat([pts[:, :, None], torch.stack(cands, dim=2)], dim=2)
    quat_all = quats[:, :, None, :].expand(b, L, e, 4)

    flat_emit = emit_all.reshape(b, -1)
    out_idx = torch.cumsum(flat_emit.long(), dim=1) - 1
    count = torch.clamp(flat_emit.sum(dim=1), max=max_plan_len)
    tgt = torch.where(flat_emit & (out_idx < max_plan_len), out_idx,
                      max_plan_len)                              # sink slot
    pos_buf = torch.zeros((b, max_plan_len + 1, 3), device=pts.device)
    quat_buf = torch.zeros((b, max_plan_len + 1, 4), device=pts.device)
    pos_buf.scatter_(1, tgt[..., None].expand(-1, -1, 3),
                     pos_all.reshape(b, -1, 3))
    quat_buf.scatter_(1, tgt[..., None].expand(-1, -1, 4),
                      quat_all.reshape(b, -1, 4))
    plan_valid = ((torch.arange(max_plan_len, device=pts.device)
                   < count[:, None]) & res.ok[:, None])
    return GlobalPlan(pos_buf[:, :max_plan_len], quat_buf[:, :max_plan_len],
                      plan_valid, torch.where(res.ok, count, 0))


class FusedPrePlan(NamedTuple):
    """What :func:`fused_pre_plan` hands to the relaxation and the post
    stage."""
    marking: MarkingState
    composed: torch.Tensor
    allowed_max_speed: torch.Tensor
    scan_global: torch.Tensor
    prep: PlanPrep
    # the depth layer's new state and latest frames (None without cameras)
    depth_marking: Optional[MarkingState] = None
    depth_buffer: Optional[DepthCameraBuffer] = None
    depth_latest: Optional[DepthCameraObservation] = None


def fused_perceive(spec: VoxelSpec, ri_spec: RangeImageSpec,
                   params: MarkingParams, fmap: FusedMap, state: FusedState,
                   scan_sensor, scan_mask, robot_pos, robot_quat,
                   sensor_offset):
    """The scan into the global frame, then mark/clear. Returns (new
    MarkingState, scan_global (B, N, 3))."""
    b = robot_pos.shape[0]
    offset = torch.as_tensor(sensor_offset, dtype=torch.float32,
                             device=robot_pos.device).expand(b, 3)
    sensor_pos = robot_pos + quat_rotate_fma(robot_quat, offset)
    scan_global = (quat_rotate_fma(robot_quat[:, None, :], scan_sensor)
                   + sensor_pos[:, None, :])
    marking = perception_update(
        spec, ri_spec, params, state.marking, fmap.map_ctx, scan_global,
        scan_mask, robot_pos, robot_quat, sensor_pos, robot_quat)
    return marking, scan_global


def fused_depth(spec: VoxelSpec, params: MarkingParams, fmap: FusedMap,
                state: FusedState, robot_pos, robot_quat,
                depth_cam: CameraModel, depth_frames=None, now=0.0,
                depth_keep_time: float = 0.5):
    """The depth-camera layer (`fused.py:357-379` of the JAX package): this
    tick's frames, when given, push into each robot's rings first; the
    layer then clears against every live buffered frustum and marks from
    the latest frames, every tick a camera is attached.

    depth_frames: (cam_pos (B, C, 3), cam_quat (B, C, 4), points
    (B, C, P, 3) world frame, mask (B, C, P)). Returns (depth MarkingState,
    DepthCameraBuffer, latest DepthCameraObservation)."""
    buf = state.depth_buffer
    now = torch.as_tensor(now, dtype=torch.float32, device=robot_pos.device)
    if depth_frames is not None:
        cam_pos, cam_quat, pts, mask = depth_frames
        for c in range(cam_pos.shape[1]):
            buf = push_observation(buf, c, cam_pos[:, c], cam_quat[:, c],
                                   pts[:, c], mask[:, c], now)
    marking, latest = depth_layer_update(
        spec, params, depth_cam, state.depth_marking, buf, now,
        depth_keep_time, fmap.map_ctx, robot_pos, robot_quat)
    return marking, buf, latest


def fused_prepare(nav_cfg: NavigationConfig, fmap: FusedMap,
                  state: FusedState, marking: MarkingState, scan_global,
                  robot_pos, goal_pos, allowed_max_speed=-1.0, depth=None,
                  no_entry_enabled=True) -> FusedPrePlan:
    """Composition (static, dynamic, depth and, under its toggle, no-entry
    layers), the speed-zone cap, the lethal cloud, and the global
    planner's pre-relaxation work (snap, LOS, entry costs, warm gate).
    ``depth`` is :func:`fused_depth`'s result; ``no_entry_enabled`` a bool
    or a (B,) bool tensor."""
    p = nav_cfg.perception
    dev = robot_pos.device
    with tracing.span("perceive.compose"):
        composed = min_dgraph(fmap.static_dgraph, marking.dgraph)
        if depth is not None:
            composed = min_dgraph(composed, depth[0].dgraph)
        if fmap.no_entry_field is not None:
            on = torch.as_tensor(no_entry_enabled, device=dev).reshape(-1, 1)
            composed = min_dgraph(composed, torch.where(
                on, fmap.no_entry_field, p.max_obstacle_distance))
        cap = torch.as_tensor(allowed_max_speed, dtype=torch.float32,
                              device=dev).expand(robot_pos.shape[0])
        if fmap.speed_zone_pts is not None:
            zone = speed_limit_at(robot_pos, fmap.speed_zone_pts,
                                  fmap.speed_zone_valid,
                                  fmap.speed_zone_speed, fma=True)
            cap = torch.where(zone > 0.0, torch.where(
                cap > 0.0, torch.minimum(cap, zone), zone), cap)
        if nav_cfg.global_planner.max_long_edges > 0:
            lethal_pts, lethal_valid = lethal_cloud_from_dgraph(
                fmap.ground, fmap.ground_valid & fmap.los_relevant, composed,
                inscribed_radius=p.inscribed_radius,
                max_lethal=nav_cfg.global_planner.max_lethal_points)
        else:
            lethal_pts = lethal_valid = None
    with tracing.span("plan.prepare"):
        prep = plan_prepare(
            nav_cfg.global_planner, fmap.nbr_idx, fmap.nbr_dist,
            fmap.nbr_valid, fmap.ground, fmap.ground_valid, composed,
            fmap.node_weight, robot_pos, goal_pos,
            inscribed_radius=p.inscribed_radius,
            inflation_descending_rate=p.inflation_descending_rate,
            lethal_pts=lethal_pts, lethal_valid=lethal_valid,
            warm_dist=state.wf_dist, warm_goal_idx=state.wf_goal_idx)
    d_marking, d_buffer, d_latest = depth if depth is not None else (
        None, None, None)
    return FusedPrePlan(marking=marking, composed=composed,
                        allowed_max_speed=cap, scan_global=scan_global,
                        prep=prep, depth_marking=d_marking,
                        depth_buffer=d_buffer, depth_latest=d_latest)


def fused_pre_plan(nav_cfg: NavigationConfig, spec: VoxelSpec,
                   ri_spec: RangeImageSpec, params: MarkingParams,
                   fmap: FusedMap, state: FusedState,
                   scan_sensor, scan_mask, robot_pos, robot_quat,
                   sensor_offset, goal_pos, allowed_max_speed=-1.0,
                   depth_cam=None, depth_frames=None, now=0.0,
                   depth_keep_time: float = 0.5,
                   no_entry_enabled=True) -> FusedPrePlan:
    """Everything before the relaxation: :func:`fused_perceive`, the depth
    layer (:func:`fused_depth`, when the state has one), then
    :func:`fused_prepare`."""
    with tracing.span("perceive.mark_clear"):
        marking, scan_global = fused_perceive(
            spec, ri_spec, params, fmap, state, scan_sensor, scan_mask,
            robot_pos, robot_quat, sensor_offset)
        depth = None
        if state.depth_marking is not None:
            depth = fused_depth(spec, params, fmap, state, robot_pos,
                                robot_quat, depth_cam, depth_frames, now,
                                depth_keep_time)
    return fused_prepare(nav_cfg, fmap, state, marking, scan_global,
                         robot_pos, goal_pos, allowed_max_speed, depth,
                         no_entry_enabled)


def fused_local(nav_cfg: NavigationConfig, generator: str,
                pre: FusedPrePlan, res: GlobalPathResult, plan: GlobalPlan,
                scan_mask, robot_pos, robot_quat, v_now, w_now,
                wf_stall) -> tuple:
    """This tick's observation (the scan and the latest depth frames,
    `stacked_perception.cpp:128-140`), prune → rollouts → critics → argmin
    on ``plan``, and the new state. Returns (FusedState, FusedOut)."""
    with tracing.span("local"):
        agg_pts, agg_mask = pre.scan_global, scan_mask
        if pre.depth_latest is not None:
            b = agg_pts.shape[0]
            agg_pts = torch.cat(
                [agg_pts, pre.depth_latest.points.reshape(b, -1, 3)], 1)
            agg_mask = torch.cat([agg_mask,
                                  pre.depth_latest.mask.reshape(b, -1)], 1)
        obs, obs_mask = device_observation(
            agg_pts, agg_mask, nav_cfg.local_planner.max_obstacle_points)
        cmd = compute_velocity_command(
            nav_cfg.local_planner, plan, robot_pos, robot_quat, v_now, w_now,
            obs, obs_mask, allowed_max_speed=pre.allowed_max_speed,
            generator=generator)
        out = FusedOut(vx=cmd.vx, wz=cmd.wz, state=cmd.state,
                       best_cost=cmd.best_cost, plan=plan, plan_ok=res.ok,
                       composed_dgraph=pre.composed, obs=obs,
                       obs_mask=obs_mask,
                       wf_iters=res.iters, best_index=cmd.best_index,
                       costs=cmd.costs)
        return FusedState(marking=pre.marking, wf_dist=res.dist_carry,
                          wf_goal_idx=res.goal_idx, wf_stall=wf_stall,
                          depth_marking=pre.depth_marking,
                          depth_buffer=pre.depth_buffer), out


def fused_post_plan(nav_cfg: NavigationConfig, generator: str,
                    fmap: FusedMap, pre: FusedPrePlan, res: GlobalPathResult,
                    scan_mask, robot_pos, robot_quat, v_now, w_now,
                    wf_stall) -> tuple:
    """Path interpolation, then :func:`fused_local`. Returns (FusedState,
    FusedOut)."""
    with tracing.span("plan.interpolate"):
        plan = interpolate_path_device(
            fmap.ground, res, max_plan_len=nav_cfg.local_planner.max_plan_len)
    return fused_local(nav_cfg, generator, pre, res, plan, scan_mask,
                       robot_pos, robot_quat, v_now, w_now, wf_stall)


def budget_stall_update(gp, wf_stall, iters):
    """Carry-reset policy against the relaxation budget: (stall_reset,
    new counter). Without a budget the reset is the classic one
    (``plan_finish``: a solve that hits ``max_relax_iters``); with one the
    reset is off (see the JAX package's docstring)."""
    if gp.relax_iters_per_tick <= 0:
        return None, wf_stall
    return torch.zeros_like(wf_stall, dtype=torch.bool), wf_stall


def fused_relax(nav_cfg: NavigationConfig, fmap: FusedMap,
                pre: FusedPrePlan):
    """The wavefront relaxation between the two halves of the tick, within
    the per-tick budget when one is set. Returns (field, edge bins or None,
    iters (B,))."""
    gp = nav_cfg.global_planner
    budget = gp.relax_iters_per_tick
    with tracing.span("plan.relax"):
        return relax(gp, fmap.nbr_idx, fmap.nbr_dist, fmap.avg_intensity,
                     fmap.ground, pre.prep,
                     budget if budget > 0 else gp.max_relax_iters,
                     fmap.wf_az, fmap.wf_bins)


def fused_finish(nav_cfg: NavigationConfig, fmap: FusedMap,
                 pre: FusedPrePlan, state: FusedState, dist, bins, iters):
    """Extraction after the relaxation. Returns (GlobalPathResult, stall
    counter)."""
    gp = nav_cfg.global_planner
    stall_reset, wf_stall = budget_stall_update(gp, state.wf_stall, iters)
    with tracing.span("plan.extract"):
        res = plan_finish(gp, fmap.nbr_idx, fmap.nbr_dist, fmap.ground,
                          pre.prep, dist, iters,
                          turn_pen=fmap.turn_pen if gp.turning_weight > 0.0
                          else None, wf_bins=bins, stall_reset=stall_reset)
    return res, wf_stall


def fused_tick(nav_cfg: NavigationConfig, spec: VoxelSpec,
               ri_spec: RangeImageSpec, params: MarkingParams,
               generator: str, fmap: FusedMap, state: FusedState,
               scan_sensor, scan_mask, robot_pos, robot_quat,
               sensor_offset, goal_pos, v_now, w_now,
               allowed_max_speed=-1.0, depth_cam=None, depth_frames=None,
               now=0.0, depth_keep_time: float = 0.5, no_entry_enabled=True):
    """One full tick for every robot. ``scan_sensor`` (B, N, 3) is each
    robot's sweep in its sensor frame; robot_pos (B, 3), robot_quat (B, 4),
    goal_pos (B, 3), v_now and w_now (B,); sensor_offset (3,) or (B, 3).
    With a state built with depth cameras, ``depth_cam`` (a CameraModel)
    runs the depth layer on this tick's ``depth_frames`` (see
    :func:`fused_depth`) at clock ``now``.

    Composed as :func:`fused_pre_plan` → :func:`fused_relax` →
    :func:`fused_finish` → :func:`fused_post_plan`, recorded as a
    ``tick`` span and its layers' spans (``runtime/tracing.py``). Returns
    (FusedState, FusedOut)."""
    with tracing.span("tick"):
        pre = fused_pre_plan(nav_cfg, spec, ri_spec, params, fmap, state,
                             scan_sensor, scan_mask, robot_pos, robot_quat,
                             sensor_offset, goal_pos, allowed_max_speed,
                             depth_cam, depth_frames, now, depth_keep_time,
                             no_entry_enabled)
        dist, bins, iters = fused_relax(nav_cfg, fmap, pre)
        res, wf_stall = fused_finish(nav_cfg, fmap, pre, state, dist, bins,
                                     iters)
        return fused_post_plan(nav_cfg, generator, fmap, pre, res,
                               scan_mask, robot_pos, robot_quat, v_now,
                               w_now, wf_stall)


def make_fused_tick(nav_cfg: NavigationConfig,
                    generator: str = "differential_drive_simple",
                    depth_cam=None, depth_keep_time: float = 0.5):
    """Returns (tick, spec, ri_spec, params); ``tick(fmap, state,
    scan_sensor, scan_mask, robot_pos, robot_quat, sensor_offset,
    goal_pos, v_now, w_now[, depth_frames=..., now=...])``. Pass
    ``depth_cam`` (a CameraModel) for a state built with depth cameras."""
    spec, ri_spec, params = _specs(nav_cfg)
    return (partial(fused_tick, nav_cfg, spec, ri_spec, params, generator,
                    depth_cam=depth_cam, depth_keep_time=depth_keep_time),
            spec, ri_spec, params)


def fleet_interpolate_path_device(ground, res: GlobalPathResult, *,
                                  max_plan_len: int, interp_steps: int = 19,
                                  min_emit: float = 0.1) -> GlobalPlan:
    """The fleet's path interpolation (`fused.py:477-536`). The JAX
    package writes it apart from the vmapped per-robot one to compact all
    robots' poses with one flat scatter; :func:`interpolate_path_device`
    is robot-batched with one scatter already, with the same emissions and
    constants, so it is this function."""
    return interpolate_path_device(ground, res, max_plan_len=max_plan_len,
                                   interp_steps=interp_steps,
                                   min_emit=min_emit)
