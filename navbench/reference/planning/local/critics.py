"""The MPC critics, batched over robots and rollouts.

Counterpart of ``dddmr_navigation_tpu/planning/local/critics.py``. The
collision critic's swept-box test always goes through
:func:`ops.swept_box_hits`, and the nearest-plan distances of the
stick-path and toward-plan critics through :func:`ops.masked_min_distance`:
on a CUDA tensor both are hand-written kernels.

Stacking semantics (`stacked_scoring_model.cpp:75-97`): a negative score
rejects the trajectory; otherwise scores accumulate.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from navbench.reference.config import CriticsConfig, CuboidConfig
from navbench.reference.geometry import (
    quat_rotate, quat_conjugate, quat_multiply, yaw_from_quat)
from navbench.reference.ops import swept_box_hits, masked_min_distance
from navbench.reference.rounding import fma_dot
from navbench.reference.planning.local.rollout import (
    Rollouts, end_positions, end_quats)


class PrunePlan(NamedTuple):
    """Padded prune plans (see planner.prune_plan)."""
    positions: torch.Tensor   # (B, P, 3)
    quats: torch.Tensor       # (B, P, 4)
    intensity: torch.Tensor   # (B, P) -1 backward / +1 forward / 0 first pose
    valid: torch.Tensor       # (B, P) bool
    count: torch.Tensor       # (B,) int64


def _norm(v):
    """Euclidean norm over the last axis, as sqrt(sum(v*v))."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def cuboid_box(cuboid: CuboidConfig, device):
    """The footprint's oriented box in the base frame, in f32: unit axes
    (3, 3) from dx=c[3]-c[0], dy=c[1]-c[0], dz=c[2]-c[0]; center (3,) as
    the mean of the corners; half extents as three floats. The same f32
    half extents go to the kernel and to the plain version. Built once
    per footprint and device: a copy to the card is a host sync."""
    return _cuboid_box(cuboid, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _cuboid_box(cuboid: CuboidConfig, device: str):
    corners = torch.tensor(cuboid.corners(), dtype=torch.float32)
    center = torch.mean(corners, dim=0)
    d = torch.stack([corners[3] - corners[0], corners[1] - corners[0],
                     corners[2] - corners[0]])
    half = _norm(d) * 0.5
    axes = d / (2.0 * half[:, None])
    return axes.to(device), center.to(device), tuple(half.tolist())


def collision_scores(r: Rollouts, cuboid: CuboidConfig, obstacles, obs_valid,
                     near_k: int = 0):
    """`CollisionModel::scoreTrajectory` (`collision_model.cpp:51-148`):
    -1 when any observed point falls inside the oriented footprint cuboid
    at any valid rollout step; 0 otherwise; 0 when fewer than 5 points.

    Args:
      obstacles: (B, M, 3) global-frame points; obs_valid: (B, M) bool.
      near_k: keep only each robot's K nearest obstacles (0 = all).
    Returns: (B, S) f32.
    """
    # The gate counts the full set, before the near-K cut.
    enough = obs_valid.sum(dim=1) >= 5                           # (B,)

    if near_k and near_k < obstacles.shape[1]:
        # The K nearest obstacles per robot. Hits are ORed, so the order
        # torch.topk returns them in does not matter; only a tie between
        # valid points at exactly equal distance across the K-th place can
        # keep a different point than lax.top_k does.
        d2r = torch.sum((obstacles - r.robot_pos[:, None, :]) ** 2, dim=-1)
        d2r = torch.where(obs_valid, d2r, torch.inf)
        sel = torch.topk(-d2r, near_k, dim=1).indices            # (B, K)
        obstacles = obstacles.gather(1, sel[..., None].expand(-1, -1, 3))
        obs_valid = obs_valid.gather(1, sel)

    axes_l, center_l, half = cuboid_box(cuboid, obstacles.device)

    # Global-frame axes and centers per (B, S, N): robot_quat ∘ Rz(theta).
    cth, sth = torch.cos(r.theta), torch.sin(r.theta)           # (B,S,N)
    q = r.robot_quat[:, None, None, :]

    def rot_z(v):  # rotate base-frame vector v (3,) by theta
        return torch.stack([cth * v[0] - sth * v[1],
                            sth * v[0] + cth * v[1],
                            v[2].expand(cth.shape)], dim=-1)     # (B,S,N,3)

    axes_g = torch.stack([quat_rotate(q, rot_z(axes_l[i])) for i in range(3)],
                         dim=-2)                                 # (B,S,N,3,3)
    # Robot-centered coordinates: at global coordinates of O(10-100 m) the
    # proj_p - proj_c cancellation would lose the ~0.4 m half extents.
    center_g = ((r.positions - r.robot_pos[:, None, None, :])
                + quat_rotate(q, rot_z(center_l)))
    proj_c = torch.sum(axes_g * center_g[..., None, :], dim=-1)  # (B,S,N,3)

    hit = swept_box_hits(axes_g, proj_c, r.step_valid,
                         obstacles - r.robot_pos[:, None, :], obs_valid, half)
    return torch.where(enough[:, None] & hit, -1.0, 0.0)


def collision_min_max_scores(r: Rollouts, cuboid: CuboidConfig, obstacles,
                             obs_valid, obstacle_chunk: int = 256):
    """`CollisionMinMaxModel::scoreTrajectory`
    (`collision_min_max_model.cpp:51-89`), plain PyTorch as the JAX package
    leaves it to XLA: -1 when a valid obstacle within 1 m of a rollout pose
    lies inside the axis-aligned bounding box of that step's transformed
    footprint cuboid; 0 otherwise; 0 when fewer than 5 points.

    Args: obstacles (B, M, 3), obs_valid (B, M). Returns (B, S) f32.
    """
    enough = obs_valid.sum(dim=1) >= 5
    corners = torch.tensor(cuboid.corners(), dtype=torch.float32,
                           device=obstacles.device)              # (8, 3)
    cth, sth = torch.cos(r.theta), torch.sin(r.theta)           # (B,S,N)
    q = r.robot_quat[:, None, None, :]

    def corner_g(c):   # corner c by Rz(theta), then robot_quat
        v = torch.stack([cth * c[0] - sth * c[1], sth * c[0] + cth * c[1],
                         c[2].expand(cth.shape)], dim=-1)
        return quat_rotate(q, v)                                 # (B,S,N,3)

    rel = r.positions - r.robot_pos[:, None, None, :]            # (B,S,N,3)
    cg = torch.stack([rel + corner_g(corners[i]) for i in range(8)], dim=3)
    lo, hi = cg.amin(dim=3), cg.amax(dim=3)                      # (B,S,N,3)
    obs = obstacles - r.robot_pos[:, None, :]
    hit = torch.zeros(r.valid.shape, dtype=torch.bool, device=obs.device)
    for c0 in range(0, obs.shape[1], obstacle_chunk):
        pts = obs[:, None, None, c0:c0 + obstacle_chunk]        # (B,1,1,C,3)
        near = fma_dot(pts - rel[..., None, :], pts - rel[..., None, :]) <= 1.0
        inside = ((pts >= lo[..., None, :]) & (pts <= hi[..., None, :])
                  ).all(dim=-1)
        bad = (inside & near & obs_valid[:, None, None, c0:c0 + obstacle_chunk]
               & r.step_valid[..., None])
        hit |= bad.flatten(2).any(dim=2)
    return torch.where(enough[:, None] & hit, -1.0, 0.0)


def stick_path_scores(r: Rollouts, plan: PrunePlan, weight: float):
    """`StickPathModel` (`stick_path_model.cpp:51-77`): Σ over steps of
    the nearest-plan distance, divided by the *prune plan's* pose count (a
    quirk of the original C++ stack); 10 when the plan has <3 poses."""
    b, s, n, _ = r.positions.shape
    nn = masked_min_distance(r.positions.reshape(b, s * n, 3),
                             r.step_valid.reshape(b, s * n),
                             plan.positions, plan.valid).reshape(b, s, n)
    total = torch.where(r.step_valid, nn, 0.0).sum(dim=2)
    total = total / torch.clamp(plan.count, min=1)[:, None]
    return torch.where((plan.count < 3)[:, None], 10.0, total)


def pure_pursuit_scores(r: Rollouts, plan: PrunePlan,
                        translation_weight: float, orientation_weight: float):
    """`PurePursuitModel` (`pure_pursuit_model.cpp:60-115`): pose delta
    between the rollout end pose and the prune plan's end pose; cost =
    tw·‖Δt‖ + ow·mod(Δyaw+3.1416, 3.1416); -4 when the plan is empty or the
    rollout has <2 points."""
    e_pos = end_positions(r)                                     # (B,S,3)
    e_quat = end_quats(r)                                        # (B,S,4)
    last_i = torch.clamp(plan.count - 1, 0, plan.positions.shape[1] - 1)
    rows = torch.arange(last_i.shape[0], device=last_i.device)
    p_pos = plan.positions[rows, last_i][:, None, :]             # (B,1,3)
    p_quat = plan.quats[rows, last_i][:, None, :]

    q_inv = quat_conjugate(e_quat)
    q_rel = quat_multiply(q_inv, p_quat)
    t_rel = quat_rotate(q_inv, p_pos - e_pos)
    # jnp.mod is a floor mod: torch.remainder, not torch.fmod.
    yaw = torch.remainder(yaw_from_quat(q_rel) + 3.1416, 3.1416)
    cost = translation_weight * _norm(t_rel) + orientation_weight * yaw
    bad = (plan.count == 0)[:, None] | (r.num_steps < 2)
    return torch.where(bad, -4.0, cost)


def toward_global_plan_scores(r: Rollouts, plan: PrunePlan, weight: float):
    """`TowardGlobalPlanModel` (`toward_global_plan_model.cpp:52-78`):
    weight × nearest-plan distance of the rollout end position; 10 when the
    plan has <3 poses."""
    e_pos = end_positions(r)
    nn = masked_min_distance(e_pos, torch.ones_like(r.valid), plan.positions,
                             plan.valid)
    return torch.where((plan.count < 3)[:, None], 10.0, nn * weight)


def shortest_angle_scores(r: Rollouts, heading_deviation, weight: float):
    """`ShortestAngleModel` (`shortest_angle_model.cpp:51-67`): weight when
    the rotation direction matches the sign of the robot's heading
    deviation (B,), 2×weight otherwise."""
    w = r.samples[..., -1]
    match = torch.where((heading_deviation >= 0)[:, None], w >= 0, w < 0)
    return torch.where(match, weight, 2.0 * weight)


def twirling_scores(r: Rollouts, weight: float):
    """`TwirlingModel` (`twirling_model.cpp:51-55`): |ω|·weight."""
    return torch.abs(r.samples[..., -1]) * weight


def score_rollouts(critics: CriticsConfig, cuboid: CuboidConfig, r: Rollouts,
                   plan: PrunePlan, obstacles, obs_valid, heading_deviation,
                   collision_near_k: int = 0, obstacle_chunk: int = 256):
    """Run the configured critic stack; returns (costs, rejected), (B, S).

    ``costs`` is the summed score of accepted rollouts; rejected rollouts
    carry their first negative critic value. Invalid rollouts are rejected
    with -1."""
    total = torch.zeros(r.valid.shape, dtype=torch.float32,
                        device=r.valid.device)
    neg_val = torch.zeros_like(total)
    rejected = torch.zeros_like(r.valid)

    def apply(score):
        nonlocal total, neg_val, rejected
        is_neg = score < 0.0
        neg_val = torch.where(rejected, neg_val,
                              torch.where(is_neg, score, neg_val))
        rejected = rejected | is_neg
        total = total + torch.where(is_neg, 0.0, score)

    if critics.collision is not None:
        apply(collision_scores(r, cuboid, obstacles, obs_valid,
                               near_k=collision_near_k)
              * critics.collision.weight)
    if critics.collision_min_max is not None:
        apply(collision_min_max_scores(r, cuboid, obstacles, obs_valid,
                                       obstacle_chunk=obstacle_chunk)
              * critics.collision_min_max.weight)
    if critics.stick_path is not None:
        apply(stick_path_scores(r, plan, 1.0) * critics.stick_path.weight)
    if critics.pure_pursuit is not None:
        apply(pure_pursuit_scores(
            r, plan, critics.pure_pursuit.translation_weight,
            critics.pure_pursuit.orientation_weight))
    if critics.toward_global_plan is not None:
        apply(toward_global_plan_scores(
            r, plan, critics.toward_global_plan.weight))
    if critics.shortest_angle is not None:
        apply(shortest_angle_scores(
            r, heading_deviation, critics.shortest_angle.weight))
    if critics.twirling is not None:
        apply(twirling_scores(r, critics.twirling.weight))

    rejected = rejected | ~r.valid
    costs = torch.where(rejected, torch.clamp(neg_val, max=-1.0), total)
    return costs, rejected


def best_trajectory(costs, rejected):
    """`Local_Planner::getBestTrajectory` (`local_planner.cpp:447-480`):
    minimum cost among accepted rollouts; on ties the *last* one wins.
    torch.argmin returns the first minimum, so search the reversed row.
    Returns (index, cost, found), each (B,)."""
    s = costs.shape[1]
    masked = torch.where(rejected, torch.inf, costs)
    idx = s - 1 - torch.argmin(masked.flip(1), dim=1)
    found = (~rejected).any(dim=1)
    best = costs.gather(1, idx[:, None])[:, 0]
    return idx, torch.where(found, best, -1.0), found
