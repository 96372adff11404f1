"""The local-planner control tick for a fleet: plan pruning, rollout,
scoring, argmin.

Counterpart of ``dddmr_navigation_tpu/planning/local/planner.py``
(`Local_Planner::computeVelocityCommand`, `local_planner.cpp:482-621`),
batched first: every input carries a leading robot axis B, and one call is
one tick of the whole fleet, with one launch of each kernel per critic.
State codes mirror `dddmr_enum_states.h:46-54`.
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from navbench.reference.config import LocalPlannerConfig
from navbench.reference.geometry import (
    normalize_angle, quat_conjugate, quat_multiply, slope_aware_quat,
    yaw_from_quat)
from navbench.reference.planning.local.sampler import (
    dd_simple_samples, omni_simple_samples, rotate_inplace_samples)
from navbench.reference.planning.local.rollout import Rollouts, rollout
from navbench.reference.planning.local.critics import (
    PrunePlan, _norm, score_rollouts, best_trajectory)


class PlannerState(enum.IntEnum):
    """`dddmr_enum_states.h:46-54`."""
    TF_FAIL = 0
    PRUNE_PLAN_FAIL = 1
    ALL_TRAJECTORIES_FAIL = 2
    PERCEPTION_MALFUNCTION = 3
    TRAJECTORY_FOUND = 4
    PATH_BLOCKED_WAIT = 5
    PATH_BLOCKED_REPLANNING = 6


class GlobalPlan(NamedTuple):
    """Padded global plans (`setPlan`, `local_planner.cpp:322-344`)."""
    positions: torch.Tensor   # (B, L, 3)
    quats: torch.Tensor       # (B, L, 4)
    valid: torch.Tensor       # (B, L) bool
    count: torch.Tensor       # (B,) int64


def make_global_plan(positions, quats=None, max_len: int = 512,
                     device="cuda") -> GlobalPlan:
    """Pad a fleet's plans of equal length n to ``max_len`` poses.

    Args:
      positions: (B, n, 3) poses, any array-like.
      quats: optional (B, n, 4); by default each pose takes the slope-aware
        orientation of its outgoing segment (the last pose its incoming).
    """
    positions = torch.as_tensor(positions, dtype=torch.float32, device=device)
    b, n, _ = positions.shape
    if quats is None:
        seg = torch.zeros_like(positions)
        seg[:, :-1] = positions[:, 1:] - positions[:, :-1]
        if n > 1:
            seg[:, -1] = seg[:, -2]
        else:
            seg[:, -1] = seg.new_tensor([1.0, 0.0, 0.0])
        quats = slope_aware_quat(seg)
    quats = torch.as_tensor(quats, dtype=torch.float32, device=positions.device)
    pad = max_len - n
    if pad < 0:
        raise ValueError(f"plan length {n} exceeds max_len {max_len}")
    pos = torch.nn.functional.pad(positions, (0, 0, 0, pad))
    q = torch.nn.functional.pad(quats, (0, 0, 0, pad))
    valid = (torch.arange(max_len, device=pos.device) < n).expand(b, -1)
    count = torch.full((b,), n, dtype=torch.int64, device=pos.device)
    return GlobalPlan(pos, q, valid.contiguous(), count)


def _take_rows(x, idx):
    """x[b, idx[b]] for (B, L, ...) x and (B,) idx."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def prune_plan(cfg: LocalPlannerConfig, plan: GlobalPlan, robot_pos,
               forward_distance=None, backward_distance=None):
    """`Local_Planner::prunePlan` (`local_planner.cpp:374-445`) without the
    KD-tree: nearest plan pose by argmin, then an arc-length window
    (inclusive of the first pose crossing the distance budget). The
    distances default to the config's prune distances.

    Returns (PrunePlan, ok (B,)). ok=False ⇒ PRUNE_PLAN_FAIL (deviation
    > 1 m or plan shorter than 3 poses).
    """
    fwd = cfg.forward_prune if forward_distance is None else forward_distance
    bwd = (cfg.backward_prune if backward_distance is None
           else backward_distance)
    b, L, _ = plan.positions.shape
    P = cfg.max_prune_len
    dev = plan.positions.device

    d = _norm(plan.positions - robot_pos[:, None, :])
    d = torch.where(plan.valid, d, torch.inf)
    i0 = torch.argmin(d, dim=1)                                  # (B,)
    ok = (plan.count >= 3) & (_take_rows(d, i0) <= 1.0)

    seg = _norm(plan.positions[:, 1:] - plan.positions[:, :-1])
    seg = torch.where(plan.valid[:, 1:], seg, 0.0)
    cum = torch.cat([torch.zeros_like(seg[:, :1]), torch.cumsum(seg, dim=1)],
                    dim=1)                                       # (B, L)

    idx = torch.arange(L, device=dev).expand(b, -1)
    i0c = i0[:, None]
    cum_i0 = cum.gather(1, i0c)
    # The 1e-5 slack keeps exact-budget boundaries inclusive under f32
    # cumsum noise, matching the reference's f64 push-then-break.
    eps = 1e-5
    # backward: pose i included iff arc(i0 → i+1) ≤ bwd.
    arc_back = cum_i0 - cum.gather(1, torch.minimum(idx + 1, i0c))
    back_ok = (idx <= i0c) & (arc_back <= bwd + eps) & plan.valid
    # forward: pose j included iff arc(i0 → j-1) ≤ fwd.
    arc_fwd = cum.gather(1, torch.maximum(idx - 1, i0c)) - cum_i0
    fwd_ok = (idx >= i0c) & (arc_fwd <= fwd + eps) & plan.valid

    include = back_ok | fwd_ok
    # torch.argmax rejects bool: first included index via an int cast.
    start = torch.argmax(include.int(), dim=1)
    count = include.sum(dim=1)

    # The window is contiguous. Pad by P rows before the gather so a window
    # starting near the end never clamps (critics index slot 0 by count).
    window_idx = start[:, None] + torch.arange(P, device=dev)   # (B, P)
    pos_p = torch.nn.functional.pad(plan.positions, (0, 0, 0, P))
    quat_p = torch.nn.functional.pad(plan.quats, (0, 0, 0, P))
    positions = pos_p.gather(1, window_idx[..., None].expand(-1, -1, 3))
    quats = quat_p.gather(1, window_idx[..., None].expand(-1, -1, 4))
    count = torch.clamp(count, max=P)
    valid = torch.arange(P, device=dev) < count[:, None]
    # intensity: -1 backward poses; forward +1, except global index 0 → 0
    # (`local_planner.cpp:404-431`).
    intensity = torch.where(window_idx < i0c, -1.0,
                            torch.where(window_idx == 0, 0.0, 1.0))
    intensity = torch.where(valid, intensity, 0.0)
    # On failure the plan is empty (the reference leaves it cleared); the
    # positions and quaternions stay as gathered.
    okc = ok[:, None]
    pp = PrunePlan(positions=positions, quats=quats,
                   intensity=torch.where(okc, intensity, 0.0),
                   valid=valid & okc,
                   count=torch.where(ok, count, 0))
    return pp, ok


def shortest_angle_to_pose_heading(robot_quat, target_quat):
    """`getShortestAngleFromPose2RobotHeading` (`local_planner.cpp:197-215`):
    yaw of (robot⁻¹ ∘ target), wrapped."""
    q_rel = quat_multiply(quat_conjugate(robot_quat), target_quat)
    return normalize_angle(yaw_from_quat(q_rel))


def initial_heading_deviation(cfg: LocalPlannerConfig, plan: GlobalPlan,
                              robot_pos, robot_quat):
    """`isInitialHeadingAligned` (`local_planner.cpp:217-271`): heading of
    the vector from the first to the last pose of a
    heading_tracking_distance prune window, against the robot's.

    Returns (yaw_deviation, aligned, ok), each (B,)."""
    pp, ok = prune_plan(cfg, plan, robot_pos,
                        forward_distance=cfg.heading_tracking_distance,
                        backward_distance=0.0)
    ok = ok & (pp.count >= 3)
    last_i = torch.clamp(pp.count - 1, 0, pp.positions.shape[1] - 1)
    v = _take_rows(pp.positions, last_i) - pp.positions[:, 0]
    yaw = shortest_angle_to_pose_heading(robot_quat, slope_aware_quat(v))
    aligned = torch.abs(yaw) < cfg.heading_align_angle
    return yaw, aligned & ok, ok


def goal_heading_deviation(cfg: LocalPlannerConfig, plan: GlobalPlan,
                           robot_quat):
    """`isGoalHeadingAligned` (`local_planner.cpp:273-304`). Returns
    (yaw_deviation, aligned), each (B,)."""
    last_i = torch.clamp(plan.count - 1, 0, plan.positions.shape[1] - 1)
    yaw = shortest_angle_to_pose_heading(robot_quat,
                                         _take_rows(plan.quats, last_i))
    return yaw, (plan.count > 0) & (torch.abs(yaw) < cfg.yaw_goal_tolerance)


def goal_reached(cfg: LocalPlannerConfig, plan: GlobalPlan, robot_pos):
    """`isGoalReached` (`local_planner.cpp:306-320`): 3D distance to the
    final plan pose under xy_goal_tolerance. Returns (B,) bool."""
    last_i = torch.clamp(plan.count - 1, 0, plan.positions.shape[1] - 1)
    d = _norm(robot_pos - _take_rows(plan.positions, last_i))
    return (plan.count > 0) & (d < cfg.xy_goal_tolerance)


class VelocityCommand(NamedTuple):
    vx: torch.Tensor           # (B,)
    wz: torch.Tensor
    vy: torch.Tensor           # nonzero only for the omni generator
    state: torch.Tensor        # PlannerState code, int32
    best_index: torch.Tensor
    best_cost: torch.Tensor
    prune: PrunePlan
    rollouts: Rollouts
    costs: torch.Tensor        # (B, S)
    rejected: torch.Tensor     # (B, S)


GENERATORS = ("differential_drive_simple", "omni_drive_simple",
              "differential_drive_rotate_inplace",
              "differential_drive_rotate_shortest_angle")


def compute_velocity_command(cfg: LocalPlannerConfig, plan: GlobalPlan,
                             robot_pos, robot_quat, v_now, w_now,
                             obstacles, obs_valid,
                             allowed_max_speed=None,
                             heading_deviation=None,
                             generator: str = "differential_drive_simple",
                             vy_now=None) -> VelocityCommand:
    """One control tick of a fleet (`computeVelocityCommand`,
    `local_planner.cpp:482-621`), minus the host-side gates.

    Args:
      plan: GlobalPlan with B plans.
      robot_pos, robot_quat: (B, 3), (B, 4); v_now, w_now: (B,).
      obstacles, obs_valid: (B, M, 3) padded observations and (B, M) mask.
      allowed_max_speed: (B,) speed-zone cap (≤0 unlimited), default -1.
      heading_deviation: (B,), default 0 (the shortest-angle critic's).
      generator: one of :data:`GENERATORS` (a static switch).
      vy_now: (B,) lateral velocity, omni generator only; default 0.
    """
    if generator not in GENERATORS:
        raise ValueError(f"unknown generator {generator}")
    b, dev = robot_pos.shape[0], robot_pos.device
    if allowed_max_speed is None:
        allowed_max_speed = torch.full((b,), -1.0, device=dev)
    if heading_deviation is None:
        heading_deviation = torch.zeros((b,), device=dev)

    pp, prune_ok = prune_plan(cfg, plan, robot_pos)

    sim_t = None
    if generator == "differential_drive_simple":
        gen = cfg.generator
        samples, valid = dd_simple_samples(gen, v_now, w_now,
                                           allowed_max_speed)
        gates = (gen.sim_time, gen.limits.min_vel_x, gen.limits.min_vel_theta,
                 gen.limits.max_vel_x)
        critics = cfg.critics
    elif generator == "omni_drive_simple":
        gen = cfg.omni_generator
        vy = torch.zeros((b,), device=dev) if vy_now is None else vy_now
        samples, valid = omni_simple_samples(gen, v_now, vy, w_now)
        # the speed-zone cap rejects by translational magnitude
        # (`omni_simple_...cpp:513-517`)
        vmag = torch.hypot(samples[..., 0], samples[..., 1])
        cap = allowed_max_speed[:, None]
        valid = valid & ((cap <= 0.0) | (vmag - 1e-4 <= cap))
        gates = (gen.sim_time, gen.limits.min_vel_trans,
                 gen.limits.min_vel_theta, gen.limits.max_vel_trans)
        critics = cfg.critics
    else:
        gen = cfg.rotate_generator
        samples, valid = rotate_inplace_samples(gen, cfg.generator.limits, b,
                                                dev)
        sim_t = 6.28 / torch.clamp(torch.abs(samples[..., 1]), min=1e-6)
        gates = (0.0, -1.0, -1.0, -1.0)
        critics = cfg.rotate_critics
    r = rollout(samples, valid, robot_pos, robot_quat, sim_time=gates[0],
                sim_granularity=gen.sim_granularity,
                angular_sim_granularity=gen.angular_sim_granularity,
                min_vel_x=gates[1], min_vel_theta=gates[2],
                max_vel_x=gates[3], max_steps=gen.max_num_steps,
                sim_time_per_sample=sim_t)

    costs, rejected = score_rollouts(
        critics, gen.cuboid, r, pp, obstacles, obs_valid, heading_deviation,
        collision_near_k=cfg.collision_near_k,
        obstacle_chunk=cfg.collision_obstacle_chunk)
    idx, cost, found = best_trajectory(costs, rejected)

    found_ok = found & prune_ok
    width = r.samples.shape[-1]
    best = r.samples.gather(1, idx[:, None, None].expand(-1, 1, width))[:, 0]
    vx = torch.where(found_ok, best[:, 0], 0.0)
    wz = torch.where(found_ok, best[:, -1], 0.0)
    vy = (torch.where(found_ok, best[:, 1], 0.0) if width == 3
          else torch.zeros_like(vx))
    state = torch.where(
        ~prune_ok, int(PlannerState.PRUNE_PLAN_FAIL),
        torch.where(found, int(PlannerState.TRAJECTORY_FOUND),
                    int(PlannerState.ALL_TRAJECTORIES_FAIL))).int()

    return VelocityCommand(vx=vx, wz=wz, vy=vy, state=state,
                           best_index=idx, best_cost=cost, prune=pp,
                           rollouts=r, costs=costs, rejected=rejected)
