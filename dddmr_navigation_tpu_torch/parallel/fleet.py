"""A fleet of robots: the local-planner tick, the fused tick, the
full-fidelity tick of bench config 4, and each of them sharded over the
ranks of ``torch.distributed``.

Counterpart of ``dddmr_navigation_tpu/parallel/fleet.py``. The JAX package
vmaps single-robot ticks over the fleet; here each tick is written with a
leading robot axis, so one fleet tick launches each kernel once per call
site. The sharded ticks (``shard_map`` over a 1-D mesh in the JAX
package) run on each rank over its own contiguous block of robots, with
the map, the submap context and the feature clouds replicated; each
``psum`` of a fleet-health scalar becomes one ``all_reduce`` over the
mesh's process group (NCCL on the card, gloo on the CPU).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from dddmr_navigation_tpu_torch.config import LocalPlannerConfig
from dddmr_navigation_tpu_torch.control.fsm import (
    CmdSource, Decision, FSMInputs, fsm_step, init_fsm_state)
from dddmr_navigation_tpu_torch.control.fused import (
    budget_stall_update, fleet_interpolate_path_device, fused_local,
    fused_pre_plan, fused_tick, init_fused_state)
from dddmr_navigation_tpu_torch.control.recovery import (
    RotateRecoveryState, rotate_recovery_step, start_rotate_recovery)
from dddmr_navigation_tpu_torch.geometry import (
    quat_conjugate, quat_from_yaw, quat_multiply, quat_rotate_fma,
    yaw_from_quat)
from dddmr_navigation_tpu_torch.ops.cuda_graph import GraphedStep
from dddmr_navigation_tpu_torch.planning.global_.planner import (
    fleet_plan_finish)
from dddmr_navigation_tpu_torch.planning.global_.wavefront import (
    fleet_wavefront_distances, fleet_wavefront_distances_turning)
from dddmr_navigation_tpu_torch.planning.local.planner import (
    GlobalPlan, PlannerState, VelocityCommand, compute_velocity_command,
    goal_heading_deviation, goal_reached, initial_heading_deviation)
from dddmr_navigation_tpu_torch.rounding import fma_dot, fma_norm
from dddmr_navigation_tpu_torch.runtime import tracing
from dddmr_navigation_tpu_torch.state_estimation.mcl import (
    Lpf3, MCLState, init_mcl, mcl_update)
from dddmr_navigation_tpu_torch.state_estimation.pf import MCLDraws, PFState


class FleetState(NamedTuple):
    """Per-robot dynamic state, batched on axis 0."""
    pos: torch.Tensor     # (B, 3)
    quat: torch.Tensor    # (B, 4)
    v: torch.Tensor       # (B,)
    w: torch.Tensor       # (B,)


def fleet_tick(cfg: LocalPlannerConfig, plans: GlobalPlan, state: FleetState,
               obstacles, obs_valid, allowed_max_speed=None,
               heading_deviation=None) -> VelocityCommand:
    """One control tick for a fleet. Returns the whole batched
    VelocityCommand; the JAX package's (vx, wz, state, best_cost) are its
    fields of the same names."""
    return compute_velocity_command(cfg, plans, state.pos, state.quat,
                                    state.v, state.w, obstacles, obs_valid,
                                    allowed_max_speed, heading_deviation)


def track_twist(v_now, w_now, vx_cmd, wz_cmd, dt, limits):
    """Acceleration-limited twist tracking within the same window the
    dynamic-window sampler offers per control period: up to v + acc·dt
    speeding up, down to v / deceleration_ratio braking, collapsing to the
    braking floor when the window inverts. Returns (v, w) achieved."""
    hi = v_now + limits.acc_lim_x * dt
    lo = v_now / limits.deceleration_ratio
    v = torch.where(lo > hi, lo, torch.minimum(torch.maximum(vx_cmd, lo), hi))
    aw = limits.acc_lim_theta * dt
    w = torch.minimum(torch.maximum(wz_cmd, w_now - aw), w_now + aw)
    return v, w


def integrate_fleet(state: FleetState, vx, wz, dt: float,
                    limits=None) -> FleetState:
    """Unicycle integration of the commanded twist, tracked through
    :func:`track_twist` when ``limits`` (a DD limits config) is given."""
    if limits is not None:
        vx, wz = track_twist(state.v, state.w, vx, wz, dt, limits)
    yaw = yaw_from_quat(state.quat)
    dx = vx * torch.cos(yaw) * dt
    dy = vx * torch.sin(yaw) * dt
    pos = state.pos + torch.stack([dx, dy, torch.zeros_like(dx)], dim=-1)
    quat = quat_multiply(state.quat, quat_from_yaw(wz * dt))
    return FleetState(pos=pos, quat=quat, v=vx, w=wz)


def fused_fleet_tick(nav_cfg, spec, ri_spec, params, fmap, states, scans,
                     scan_masks, positions, quats, sensor_offset, goals,
                     v_now, w_now):
    """One fused perception → replan → local tick for a fleet on a shared
    map (the JAX package's vmapped ``fused_fleet_tick``). Returns
    (new states, vx (B,), wz (B,), state codes (B,), plan_ok (B,))."""
    s2, out = fused_tick(nav_cfg, spec, ri_spec, params,
                         "differential_drive_simple", fmap, states, scans,
                         scan_masks, positions, quats, sensor_offset, goals,
                         v_now, w_now)
    return s2, out.vx, out.wz, out.state, out.plan_ok


# ---------------------------------------------------------------------------
# the full-fidelity fleet tick: localize (MCL on drifting odometry) →
# perceive (mark/clear) → replan (turning wavefront + LOS, one relaxation
# for the fleet) → FSM → generator selection (simple / rotate-shortest-
# angle) → rotate-in-place recovery → integrate (`p2p_move_base.cpp:
# 265-658`, `mcl_3dl.cpp:143-234`, `rotate_inplace_behavior.cpp:123-310`)
# ---------------------------------------------------------------------------

class FleetFullState(NamedTuple):
    """Everything a robot carries from tick to tick, batched on axis 0."""
    fused: object                 # control.fused.FusedState
    fsm: object                   # control.fsm.FSMState
    recovery: object              # control.recovery.RotateRecoveryState
    recovery_succeed: torch.Tensor  # (B,) bool, last completed result
    pos: torch.Tensor             # (B, 3) true pose (the simulation's)
    quat: torch.Tensor            # (B, 4)
    v: torch.Tensor               # (B,)
    w: torch.Tensor               # (B,)
    mcl: Optional[object]         # state_estimation.mcl.MCLState or None
    odom_prev_pos: torch.Tensor   # (B, 3) previous odometry sample
    odom_prev_quat: torch.Tensor  # (B, 4)


def init_fleet_full_state(nav_cfg, num_ground_nodes: int, positions, quats,
                          mcl_cfg=None, mcl_normals=None,
                          device="cuda") -> FleetFullState:
    """Every robot at rest at ``positions``/``quats`` ((B, 3)/(B, 4) array
    likes), the FSM in d_initial, no recovery. With ``mcl_cfg`` the
    filters start at the true poses, their particles spread by
    ``mcl_normals``: two (B, N, 3) tensors of unit normals (see
    ``state_estimation.mcl.init_draws``)."""

    pos = torch.as_tensor(np.asarray(positions, np.float32), device=device)
    quat = torch.as_tensor(np.asarray(quats, np.float32), device=device)
    b = pos.shape[0]
    zeros = torch.zeros((b,), device=device)
    no = torch.zeros((b,), dtype=torch.bool, device=device)
    mcl = None
    if mcl_cfg is not None:
        if mcl_normals is None:
            raise ValueError("MCL needs its particles' initial normals")
        mcl = init_mcl(mcl_cfg, pos, quat, *mcl_normals)
    return FleetFullState(
        fused=init_fused_state(nav_cfg, num_ground_nodes, pos),
        fsm=init_fsm_state(b, device=device),
        recovery=RotateRecoveryState(start_yaw=zeros, got_180=no,
                                     active=no.clone()),
        recovery_succeed=no.clone(), pos=pos, quat=quat, v=zeros.clone(),
        w=zeros.clone(), mcl=mcl, odom_prev_pos=pos, odom_prev_quat=quat)


def feature_keys(n: int, device) -> torch.Tensor:
    """The Knuth-hash order keys ((i · 2654435761) mod 2³²) >> 12 of ``n``
    cloud points, int64."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return ((i * 2654435761) % 2 ** 32) >> 12


def device_features_from_map(map_pts, ground_pts, pose_pos, pose_quat,
                             n_sharp: int = 512, n_flat: int = 256,
                             radius: float = 8.0, keys=None):
    """Each robot's MCL feature clouds, on the device: up to ``n_sharp``
    map points and ``n_flat`` ground points within ``radius`` of its true
    pose (B, 3)/(B, 4), in its base frame — the fleet's stand-in for the
    lego-loam feature front end (`mcl_feature_node.cpp:15-35`). Points are
    taken in Knuth-hash order, not nearest first (a nearest-n cloud
    collapses onto the closest wall and loses the along-wall direction);
    the order is a stable sort, so equal keys go to the lower index as in
    ``lax.top_k``. ``keys`` takes precomputed (map, ground) keys.

    Returns (flat (B, n_flat, 3), flat_ok, sharp (B, n_sharp, 3), sharp_ok).
    """
    def pick(pts, n, key):
        d = pts[None] - pose_pos[:, None, :]
        inr = fma_dot(d, d) <= radius * radius
        key = torch.where(inr, key, 2 ** 30)
        k = min(n, pts.shape[0])
        srt = torch.sort(key, dim=1, stable=True)
        idx, ok = srt.indices[:, :k], srt.values[:, :k] < 2 ** 30
        rel = quat_rotate_fma(quat_conjugate(pose_quat)[:, None, :],
                              pts[idx] - pose_pos[:, None, :])
        rel = torch.where(ok[..., None], rel, 0.0)
        if k < n:                       # pad to the static budget
            rel = torch.nn.functional.pad(rel, (0, 0, 0, n - k))
            ok = torch.nn.functional.pad(ok, (0, n - k))
        return rel, ok

    if keys is None:
        keys = (feature_keys(map_pts.shape[0], map_pts.device),
                feature_keys(ground_pts.shape[0], ground_pts.device))
    sharp, sharp_ok = pick(map_pts, n_sharp, keys[0])
    flat, flat_ok = pick(ground_pts, n_flat, keys[1])
    return flat, flat_ok, sharp, sharp_ok


class FleetLocalization(NamedTuple):
    """What stage A's localization hands on."""
    mcl: Optional[object]         # MCLState after this tick's update
    odom_pos: torch.Tensor        # (B, 3) this tick's odometry
    odom_quat: torch.Tensor       # (B, 4)
    plan_pos: torch.Tensor        # (B, 3) the pose planning starts from
    plan_quat: torch.Tensor       # (B, 4)
    mcl_err: torch.Tensor         # (B,) |estimate − truth|, 0 without MCL
    match_ratio: torch.Tensor     # (B,)


# The localize step's CUDA graphs (one per shape, MCL config, submap and
# feature clouds).
LOCALIZE_GRAPHS = GraphedStep("localize")


def fleet_localize(state, dt, mcl_cfg=None, submap_ctx=None,
                   odom_drift_pos=None, odom_drift_yaw=None,
                   feature_map_pts=None, feature_ground_pts=None,
                   mcl_draws=None, feature_keys_=None) -> FleetLocalization:
    """Stage A's localization: with ``mcl_cfg`` and filters in the state,
    each robot's MCL update against the drifting odometry (true pose ∘
    drift), fed the feature clouds of its true pose; otherwise the true
    pose is the planning pose. On CUDA tensors the update replays as a
    CUDA graph (:data:`LOCALIZE_GRAPHS`, keyed by the shapes, ``mcl_cfg``,
    the submap and the feature clouds and keys); on CPU tensors it runs
    eagerly."""

    b, dev = state.pos.shape[0], state.pos.device
    if state.mcl is None or mcl_cfg is None:
        zeros = torch.zeros((b,), device=dev)
        return FleetLocalization(state.mcl, state.pos, state.quat, state.pos,
                                 state.quat, zeros, zeros)
    drift_pos = (torch.zeros((b, 3), device=dev) if odom_drift_pos is None
                 else odom_drift_pos)
    drift_yaw = (torch.zeros((b,), device=dev) if odom_drift_yaw is None
                 else odom_drift_yaw)
    tensors = (state.pos, state.quat, state.odom_prev_pos,
               state.odom_prev_quat, drift_pos, drift_yaw,
               torch.as_tensor(dt, dtype=torch.float32, device=dev),
               *_mcl_leaves(state.mcl), *mcl_draws)

    def step(*t):
        return _localize_step(mcl_cfg, submap_ctx, feature_map_pts,
                              feature_ground_pts, feature_keys_, *t)
    if state.pos.is_cuda:
        keys = feature_keys_ or ()
        out = LOCALIZE_GRAPHS(
            step, (mcl_cfg, id(submap_ctx), id(feature_map_pts),
                   id(feature_ground_pts), tuple(id(k) for k in keys)),
            tensors, keep=(submap_ctx, feature_map_pts, feature_ground_pts,
                           keys))
    else:
        out = step(*tensors)
    n = len(out) - len(FleetLocalization._fields) + 1
    return FleetLocalization(_mcl_from_leaves(out[:n]), *out[n:])


def _mcl_leaves(mcl: MCLState) -> tuple:
    return (*mcl.particles, mcl.state_prev_pos, mcl.state_prev_quat,
            *mcl.f_pos, *mcl.f_ang)


def _mcl_from_leaves(leaves) -> MCLState:
    n = len(PFState._fields)
    return MCLState(PFState(*leaves[:n]), leaves[n], leaves[n + 1],
                    Lpf3(*leaves[n + 2:n + 4]), Lpf3(*leaves[n + 4:n + 6]))


def _localize_step(mcl_cfg, submap_ctx, feature_map_pts, feature_ground_pts,
                   feature_keys_, pos, quat, odom_prev_pos, odom_prev_quat,
                   drift_pos, drift_yaw, dt, *rest) -> tuple:
    """:func:`fleet_localize`'s eager body: the leaves of the MCL state
    and draws in ``rest``, the leaves of its FleetLocalization out. It
    makes no host read and no host-to-device copy, so a CUDA graph can
    capture it."""
    n = len(rest) - len(MCLDraws._fields)
    mcl, draws = _mcl_from_leaves(rest[:n]), MCLDraws(*rest[n:])
    odom_pos = pos + drift_pos
    odom_quat = quat_multiply(quat, quat_from_yaw(drift_yaw))
    flat, flat_ok, sharp, sharp_ok = device_features_from_map(
        feature_map_pts, feature_ground_pts, pos, quat, keys=feature_keys_)
    mcl2, mout = mcl_update(
        mcl_cfg, submap_ctx, mcl, odom_prev_pos, odom_prev_quat, odom_pos,
        odom_quat, dt, flat, flat_ok, sharp, sharp_ok,
        torch.ones(sharp.shape[:2], device=pos.device), draws)
    return (*_mcl_leaves(mcl2), odom_pos, odom_quat, mout.pose_pos,
            mout.pose_quat, fma_norm(mout.pose_pos - pos),
            mout.match_ratio_max)


def fleet_perceive(nav_cfg, spec, ri_spec, params, fmap, state,
                   loc: FleetLocalization, scans, scan_masks, sensor_offset,
                   goals):
    """Stage A's perception from the planning pose: mark/clear,
    composition and the global planner's pre-relaxation work. Returns the
    FusedPrePlan."""
    return fused_pre_plan(nav_cfg, spec, ri_spec, params, fmap, state.fused,
                          scans, scan_masks, loc.plan_pos, loc.plan_quat,
                          sensor_offset, goals)


def fleet_relax(nav_cfg, fmap, pre):
    """Stage B's relaxation: one relaxation of every robot's field on the
    shared graph, with one iteration count. Returns (fields, iters ())."""
    gp = nav_cfg.global_planner
    prep = pre.prep
    budget = gp.relax_iters_per_tick
    max_it = budget if budget > 0 else gp.max_relax_iters
    if gp.turning_weight > 0.0:
        return fleet_wavefront_distances_turning(
            fmap.nbr_idx, fmap.nbr_dist, prep.graph_valid, prep.enter,
            fmap.avg_intensity, prep.goal_idx, gp.turning_weight,
            az=fmap.wf_az, bin_of_edge=fmap.wf_bins,
            n_dir_bins=gp.turning_dir_bins, max_iters=max_it,
            dist0_r=prep.warm_dist)
    return fleet_wavefront_distances(
        fmap.nbr_idx, fmap.nbr_dist, prep.graph_valid, prep.enter,
        fmap.avg_intensity, prep.goal_idx, max_iters=max_it,
        dist0_r=prep.warm_dist)


def fleet_extract(nav_cfg, fmap, state, pre, dist_r, iters):
    """Stage B's extraction and interpolation. Returns (GlobalPathResult,
    stall counter, GlobalPlan)."""
    gp = nav_cfg.global_planner
    stall_reset, wf_stall = budget_stall_update(gp, state.fused.wf_stall,
                                                iters)
    with tracing.span("plan.extract"):
        res = fleet_plan_finish(
            gp, fmap.nbr_idx, fmap.nbr_dist, fmap.ground, pre.prep, dist_r,
            iters, turn_pen=fmap.turn_pen if gp.turning_weight > 0.0
            else None, wf_bins=fmap.wf_bins, stall_reset=stall_reset)
    with tracing.span("plan.interpolate"):
        plans = fleet_interpolate_path_device(
            fmap.ground, res,
            max_plan_len=nav_cfg.local_planner.max_plan_len)
    return res, wf_stall, plans


def fleet_simple_local(nav_cfg, state, loc: FleetLocalization, pre, res,
                       plans, scan_masks, wf_stall):
    """Stage C's simple generator: observation, prune, rollouts, critics.
    Returns (FusedState, FusedOut)."""
    return fused_local(nav_cfg, "differential_drive_simple", pre, res,
                       plans, scan_masks, loc.plan_pos, loc.plan_quat,
                       state.v, state.w, wf_stall)


def fleet_decide(nav_cfg, mb_cfg, state, a: FleetLocalization, fused2, out,
                 now, dt):
    """Stage C after the simple generator: heading predicates, the
    rotate-shortest-angle command, recovery progress, the FSM, the
    command mux and the tracked integration of the true pose. Returns
    (FleetFullState, diag dict of (B,) tensors)."""

    lp = nav_cfg.local_planner
    plan_pos, plan_quat = a.plan_pos, a.plan_quat
    init_dev, init_aligned, _ = initial_heading_deviation(
        lp, out.plan, plan_pos, plan_quat)
    goal_dev, goal_aligned = goal_heading_deviation(lp, out.plan, plan_quat)
    hd = torch.where(state.fsm.decision == int(Decision.D_ALIGN_GOAL_HEADING),
                     goal_dev, init_dev)
    cmd_rot = compute_velocity_command(
        lp, out.plan, plan_pos, plan_quat, state.v, state.w, out.obs,
        out.obs_mask, heading_deviation=hd,
        generator="differential_drive_rotate_shortest_angle")
    reached = goal_reached(lp, out.plan, plan_pos)

    # recovery progress, before the FSM reads it
    was_active = state.recovery.active
    rec_step, wz_rec, rec_done, rec_failed = rotate_recovery_step(
        lp, state.recovery, plan_pos, plan_quat, out.obs, out.obs_mask)
    rec2 = type(rec_step)(*(torch.where(was_active, x, y)
                            for x, y in zip(rec_step, state.recovery)))
    rec_succeed = torch.where(
        was_active & rec_done, True,
        torch.where(was_active & rec_failed, False, state.recovery_succeed))
    rec_active = was_active & ~rec_done & ~rec_failed

    # the decision FSM; the fused vertical replans every tick, so a plan
    # arrives every tick (the device analogue of the 5 Hz query loop)
    x = FSMInputs(
        now=now, robot_pos=plan_pos, robot_yaw=yaw_from_quat(plan_quat),
        has_new_plan=torch.ones_like(out.plan_ok), plan_empty=~out.plan_ok,
        goal_reached=reached, initial_heading_aligned=init_aligned,
        goal_heading_aligned=goal_aligned, ps_simple=out.state,
        ps_rotate=cmd_rot.state, recovery_active=rec_active,
        recovery_succeed=rec_succeed)
    fsm2, fout = fsm_step(mb_cfg, state.fsm, x)

    # a recovery the FSM just asked for starts now
    start_now = fout.request_recovery & ~rec_active
    fresh = start_rotate_recovery(plan_quat)
    rec3 = type(fresh)(*(torch.where(start_now, x_, y)
                         for x_, y in zip(fresh, rec2)))

    # the command mux; an active recovery owns cmd_vel
    simple = fout.cmd_source == int(CmdSource.SIMPLE)
    rotate = fout.cmd_source == int(CmdSource.ROTATE)
    vx = torch.where(simple, out.vx, torch.where(rotate, cmd_rot.vx, 0.0))
    wz = torch.where(simple, out.wz, torch.where(rotate, cmd_rot.wz, 0.0))
    vx = torch.where(rec_active, 0.0, vx)
    wz = torch.where(rec_active, wz_rec, wz)

    # the true pose tracks the command under the sampler's limits
    v_ach, w_ach = track_twist(state.v, state.w, vx, wz, dt,
                               lp.generator.limits)
    yaw = yaw_from_quat(state.quat)
    pos2 = state.pos + torch.stack([v_ach * torch.cos(yaw) * dt,
                                    v_ach * torch.sin(yaw) * dt,
                                    torch.zeros_like(v_ach)], dim=-1)
    quat2 = quat_multiply(state.quat, quat_from_yaw(w_ach * dt))

    s2 = FleetFullState(
        fused=fused2, fsm=fsm2, recovery=rec3, recovery_succeed=rec_succeed,
        pos=pos2, quat=quat2, v=v_ach, w=w_ach, mcl=a.mcl,
        odom_prev_pos=a.odom_pos, odom_prev_quat=a.odom_quat)
    diag = {
        "vx": vx, "wz": wz, "v_achieved": v_ach, "w_achieved": w_ach,
        "decision": fsm2.decision, "cmd_source": fout.cmd_source,
        "ps_simple": out.state, "ps_rotate": cmd_rot.state,
        "plan_ok": out.plan_ok, "recovery_active": rec_active,
        "recovery_succeed": rec_succeed, "wf_iters": out.wf_iters,
        "init_aligned": init_aligned, "goal_aligned": goal_aligned,
        "goal_reached": reached, "plan_empty": ~out.plan_ok,
        "plan_pos": plan_pos, "plan_yaw": yaw_from_quat(plan_quat),
        "best_index": out.best_index, "rot_best_index": cmd_rot.best_index,
        "mcl_err": a.mcl_err, "match_ratio": a.match_ratio,
    }
    return s2, diag


def fleet_full_tick(nav_cfg, mb_cfg, spec, ri_spec, params, fmap, state,
                    scans, scan_masks, sensor_offset, goals, now, dt,
                    mcl_cfg=None, submap_ctx=None, odom_drift_pos=None,
                    odom_drift_yaw=None, feature_map_pts=None,
                    feature_ground_pts=None, mcl_draws=None,
                    feature_keys_=None):
    """One full tick of every robot (`parallel/fleet.py:311-524`).

    With ``mcl_cfg`` (and filters in ``state``) each robot first runs its
    MCL update against the drifting odometry, drawing from ``mcl_draws``
    (:class:`state_estimation.pf.MCLDraws`), and plans from the estimate;
    otherwise from the true pose. Stage A (localize + perceive), stage B
    (one relaxation for the fleet, extraction, interpolation) and stage C
    (simple and rotate generators, recovery, FSM, integration) run in turn.
    ``now`` and ``dt`` are () f32 tensors (or floats), ``scans`` (B, N, 3)
    in the sensor frame, ``goals`` (B, 3).

    The tick is recorded as a ``tick`` span with its layers' spans
    (``runtime/tracing.py``).

    Returns (new FleetFullState, diag dict of (B,) tensors)."""
    with tracing.span("tick"):
        dev = state.pos.device
        now = torch.as_tensor(now, dtype=torch.float32, device=dev)
        dt = torch.as_tensor(dt, dtype=torch.float32, device=dev)
        with tracing.span("localize"):
            loc = fleet_localize(
                state, dt, mcl_cfg=mcl_cfg, submap_ctx=submap_ctx,
                odom_drift_pos=odom_drift_pos, odom_drift_yaw=odom_drift_yaw,
                feature_map_pts=feature_map_pts,
                feature_ground_pts=feature_ground_pts, mcl_draws=mcl_draws,
                feature_keys_=feature_keys_)
        pre = fleet_perceive(nav_cfg, spec, ri_spec, params, fmap, state,
                             loc, scans, scan_masks, sensor_offset, goals)
        with tracing.span("plan.relax"):
            dist_r, iters = fleet_relax(nav_cfg, fmap, pre)
        res, wf_stall, plans = fleet_extract(nav_cfg, fmap, state, pre,
                                             dist_r, iters)
        fused2, out = fleet_simple_local(nav_cfg, state, loc, pre, res,
                                         plans, scan_masks, wf_stall)
        with tracing.span("decide"):
            return fleet_decide(nav_cfg, mb_cfg, state, loc, fused2, out,
                                now, dt)


# ---------------------------------------------------------------------------
# sharded fleets: robots split over the ranks of torch.distributed
# ---------------------------------------------------------------------------

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_fleet_mesh(axis: str = "scenarios", device="cuda"):
    """A 1-D ``DeviceMesh`` named ``axis`` over every rank of the default
    process group, which must already be initialized with the backend of
    ``device`` (NCCL for the card, gloo for the CPU; neither stands in
    for the other)."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = torch.device(device).type
    if not dist.is_initialized():
        raise RuntimeError("make_fleet_mesh needs an initialized process "
                           "group")
    backend = dist.get_backend()
    if backend != _BACKEND[device_type]:
        raise RuntimeError(f"a {device_type} fleet mesh needs the "
                           f"{_BACKEND[device_type]} backend, not {backend}")
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(axis,))


def rank_block(mesh) -> tuple[int, int]:
    """(this rank's block, number of blocks) of a robot batch split over
    every axis of ``mesh`` flattened in order (``P(axes)``)."""
    coord = mesh.get_coordinate()
    index = 0
    for c, size in zip(coord, mesh.mesh.shape):
        index = index * size + c
    return index, mesh.mesh.numel()


def _tree_map(fn, tree):
    """``fn`` on every tensor of nested NamedTuples, tuples, lists and
    dicts; other leaves (None, Python scalars) kept."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return tree


def shard_fleet_arrays(mesh, tree, axis: str = "scenarios"):
    """This rank's contiguous block of axis 0 of every tensor in ``tree``
    (robot-batched NamedTuples, tuples, lists, dicts), as ``P(axis)``
    places it. Axis 0 must divide evenly over the mesh."""
    index, count = rank_block(mesh)

    def block(x):
        if x.dim() == 0 or x.shape[0] % count:
            raise ValueError(f"axis 0 of a {tuple(x.shape)} tensor does not "
                             f"split over {count} ranks")
        n = x.shape[0] // count
        return x[index * n:(index + 1) * n]
    return _tree_map(block, tree)


def _psum(x, group):
    """The sum of ``x`` over the ranks of ``group`` (one all_reduce)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _found_count(codes):
    return (codes == int(PlannerState.TRAJECTORY_FOUND)).to(
        torch.float32).sum()


def sharded_fleet_tick(cfg: LocalPlannerConfig, mesh,
                       axis: str = "scenarios"):
    """The fleet tick over this rank's robots, and a fleet-health scalar
    replicated on every rank: the mean best cost of the robots that found
    a trajectory, over the whole fleet (two all_reduces: the sum and the
    count). The returned callable takes this rank's (plans, state,
    obstacles, obs_valid) and returns (vx, wz, state codes, best costs,
    mean cost)."""
    group = mesh.get_group(axis)

    def tick(plans, state, obstacles, obs_valid):
        cmd = fleet_tick(cfg, plans, state, obstacles, obs_valid)
        ok = cmd.best_cost >= 0
        total = _psum(torch.where(ok, cmd.best_cost, 0.0).sum(), group)
        cnt = _psum(ok.to(torch.float32).sum(), group)
        return (cmd.vx, cmd.wz, cmd.state, cmd.best_cost,
                total / torch.clamp(cnt, min=1.0))
    return tick


def sharded_fused_fleet_tick(nav_cfg, spec, ri_spec, params, mesh,
                             axis: str = "scenarios"):
    """The fused fleet tick over this rank's robots on the replicated map,
    and the count of robots at TRAJECTORY_FOUND over the whole fleet (one
    all_reduce). The returned callable takes (fmap, states, scans,
    scan_masks, positions, quats, sensor_offset, goals, v_now, w_now),
    the per-robot ones this rank's, and returns (states, vx, wz, state
    codes, plan_ok, found)."""
    group = mesh.get_group(axis)

    def tick(fmap, states, scans, scan_masks, positions, quats,
             sensor_offset, goals, v_now, w_now):
        s2, vx, wz, codes, ok = fused_fleet_tick(
            nav_cfg, spec, ri_spec, params, fmap, states, scans, scan_masks,
            positions, quats, sensor_offset, goals, v_now, w_now)
        return s2, vx, wz, codes, ok, _psum(_found_count(codes), group)
    return tick


def sharded_fleet_full_tick(nav_cfg, mb_cfg, spec, ri_spec, params, mesh,
                            axis: str = "scenarios", mcl_cfg=None,
                            localize: bool = False):
    """The full-fidelity fleet tick over this rank's robots, with the map,
    the submap context and the feature clouds replicated, and the count
    of robots whose simple generator holds TRAJECTORY_FOUND over the
    whole fleet (one all_reduce). The relaxation of stage B runs over
    this rank's robots, as ``shard_map`` runs it on each shard. The
    returned callable takes (fmap, submap_ctx, feat_map, feat_ground,
    state, scans, scan_masks, sensor_offset, goals, now, dt, drift_pos,
    drift_yaw, mcl_draws=None, feature_keys_=None), the per-robot ones
    (state, scans, masks, goals, drifts, draws) this rank's, and returns
    (state, diag, found)."""
    group = mesh.get_group(axis)

    def tick(fmap, submap_ctx, feat_map, feat_ground, state, scans,
             scan_masks, sensor_offset, goals, now, dt, drift_pos,
             drift_yaw, mcl_draws=None, feature_keys_=None):
        s2, diag = fleet_full_tick(
            nav_cfg, mb_cfg, spec, ri_spec, params, fmap, state, scans,
            scan_masks, sensor_offset, goals, now, dt,
            mcl_cfg=mcl_cfg if localize else None, submap_ctx=submap_ctx,
            odom_drift_pos=drift_pos, odom_drift_yaw=drift_yaw,
            feature_map_pts=feat_map, feature_ground_pts=feat_ground,
            mcl_draws=mcl_draws, feature_keys_=feature_keys_)
        return s2, diag, _psum(_found_count(diag["ps_simple"]), group)
    return tick
