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

from dddmr_navigation_tpu_torch.config import LocalPlannerConfig
from dddmr_navigation_tpu_torch.geometry import slope_aware_quat
from dddmr_navigation_tpu_torch.planning.local.sampler import dd_simple_samples
from dddmr_navigation_tpu_torch.planning.local.rollout import Rollouts, rollout
from dddmr_navigation_tpu_torch.planning.local.critics import (
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


def prune_plan(cfg: LocalPlannerConfig, plan: GlobalPlan, robot_pos):
    """`Local_Planner::prunePlan` (`local_planner.cpp:374-445`) without the
    KD-tree: nearest plan pose by argmin, then an arc-length window
    (inclusive of the first pose crossing the distance budget).

    Returns (PrunePlan, ok (B,)). ok=False ⇒ PRUNE_PLAN_FAIL (deviation
    > 1 m or plan shorter than 3 poses).
    """
    fwd, bwd = cfg.forward_prune, cfg.backward_prune
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


def goal_reached(cfg: LocalPlannerConfig, plan: GlobalPlan, robot_pos):
    """`isGoalReached` (`local_planner.cpp:306-320`): 3D distance to the
    final plan pose under xy_goal_tolerance. Returns (B,) bool."""
    last_i = torch.clamp(plan.count - 1, 0, plan.positions.shape[1] - 1)
    d = _norm(robot_pos - _take_rows(plan.positions, last_i))
    return (plan.count > 0) & (d < cfg.xy_goal_tolerance)


class VelocityCommand(NamedTuple):
    vx: torch.Tensor           # (B,)
    wz: torch.Tensor
    vy: torch.Tensor           # zero: the omni generator is not ported
    state: torch.Tensor        # PlannerState code, int32
    best_index: torch.Tensor
    best_cost: torch.Tensor
    prune: PrunePlan
    rollouts: Rollouts
    costs: torch.Tensor        # (B, S)
    rejected: torch.Tensor     # (B, S)


_NOT_PORTED = ("omni_drive_simple", "differential_drive_rotate_inplace",
               "differential_drive_rotate_shortest_angle")


def compute_velocity_command(cfg: LocalPlannerConfig, plan: GlobalPlan,
                             robot_pos, robot_quat, v_now, w_now,
                             obstacles, obs_valid,
                             allowed_max_speed=None,
                             heading_deviation=None,
                             generator: str = "differential_drive_simple"
                             ) -> VelocityCommand:
    """One control tick of a fleet (`computeVelocityCommand`,
    `local_planner.cpp:482-621`), minus the host-side gates.

    Args:
      plan: GlobalPlan with B plans.
      robot_pos, robot_quat: (B, 3), (B, 4); v_now, w_now: (B,).
      obstacles, obs_valid: (B, M, 3) padded observations and (B, M) mask.
      allowed_max_speed: (B,) speed-zone cap (≤0 unlimited), default -1.
      heading_deviation: (B,), default 0.
      generator: only 'differential_drive_simple' is ported.
    """
    if generator in _NOT_PORTED:
        raise NotImplementedError(f"generator {generator} is not ported yet")
    if generator != "differential_drive_simple":
        raise ValueError(f"unknown generator {generator}")
    b = robot_pos.shape[0]
    if allowed_max_speed is None:
        allowed_max_speed = torch.full((b,), -1.0, device=robot_pos.device)
    if heading_deviation is None:
        heading_deviation = torch.zeros((b,), device=robot_pos.device)

    pp, prune_ok = prune_plan(cfg, plan, robot_pos)

    gen = cfg.generator
    samples, valid = dd_simple_samples(gen, v_now, w_now, allowed_max_speed)
    r = rollout(samples, valid, robot_pos, robot_quat,
                sim_time=gen.sim_time, sim_granularity=gen.sim_granularity,
                angular_sim_granularity=gen.angular_sim_granularity,
                min_vel_x=gen.limits.min_vel_x,
                min_vel_theta=gen.limits.min_vel_theta,
                max_vel_x=gen.limits.max_vel_x,
                max_steps=gen.max_num_steps)

    costs, rejected = score_rollouts(
        cfg.critics, gen.cuboid, r, pp, obstacles, obs_valid,
        heading_deviation, collision_near_k=cfg.collision_near_k)
    idx, cost, found = best_trajectory(costs, rejected)

    found_ok = found & prune_ok
    best = r.samples.gather(1, idx[:, None, None].expand(-1, 1, 2))[:, 0]
    vx = torch.where(found_ok, best[:, 0], 0.0)
    wz = torch.where(found_ok, best[:, 1], 0.0)
    state = torch.where(
        ~prune_ok, int(PlannerState.PRUNE_PLAN_FAIL),
        torch.where(found, int(PlannerState.TRAJECTORY_FOUND),
                    int(PlannerState.ALL_TRAJECTORIES_FAIL))).int()

    return VelocityCommand(vx=vx, wz=wz, vy=torch.zeros_like(vx), state=state,
                           best_index=idx, best_cost=cost, prune=pp,
                           rollouts=r, costs=costs, rejected=rejected)
