"""The rotate-in-place recovery behavior, batched over robots.

Counterpart of ``dddmr_navigation_tpu/control/recovery.py``
(`RotateInPlaceBehavior::runBehavior`, `rotate_inplace_behavior.cpp:
123-310`): rotate a full revolution, tracked as "reach 180° from the start,
then come back home within tolerance", re-scoring the two rotate-in-place
rollouts against the fresh observation every step; a collision (both
rollouts rejected) fails the recovery. One call is one step of every
robot's recovery, with no host branch on tensor values.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import NamedTuple

import torch

from navbench.reference.config import LocalPlannerConfig
from navbench.reference.geometry import (
    shortest_angular_distance, yaw_from_quat)
from navbench.reference.planning.local.sampler import (
    rotate_inplace_samples)
from navbench.reference.planning.local.rollout import rollout
from navbench.reference.planning.local.critics import (
    PrunePlan, best_trajectory, score_rollouts)


class RecoveryState(enum.IntEnum):
    """`dddmr_enum_states.h:56-62`."""
    RECOVERY_BEHAVIOR_NOT_FOUND = 0
    INTERRUPT_BY_CANCEL = 1
    INTERRUPT_BY_NEW_GOAL = 2
    RECOVERY_DONE = 3
    RECOVERY_FAIL = 4


class RotateRecoveryState(NamedTuple):
    start_yaw: torch.Tensor   # (B,) f32
    got_180: torch.Tensor     # (B,) bool
    active: torch.Tensor      # (B,) bool


def start_rotate_recovery(robot_quat) -> RotateRecoveryState:
    """A fresh recovery for every robot, starting at its yaw."""
    b = robot_quat.shape[0]
    dev = robot_quat.device
    return RotateRecoveryState(
        start_yaw=yaw_from_quat(robot_quat),
        got_180=torch.zeros((b,), dtype=torch.bool, device=dev),
        active=torch.ones((b,), dtype=torch.bool, device=dev))


def rotate_recovery_step(cfg: LocalPlannerConfig, rec: RotateRecoveryState,
                         robot_pos, robot_quat, obstacles, obs_valid,
                         tolerance: float = 0.3):
    """One recovery step of every robot. robot_pos (B, 3), robot_quat
    (B, 4), obstacles (B, M, 3), obs_valid (B, M). Only the collision
    critic scores the rotate rollouts here (the reference's recovery
    binding), against an empty prune plan.

    Returns (rec', wz_cmd, done, failed), each (B,)."""
    gen = cfg.rotate_generator
    b, dev = robot_pos.shape[0], robot_pos.device
    samples, valid = rotate_inplace_samples(gen, cfg.generator.limits, b, dev)
    sim_t = 6.28 / torch.clamp(torch.abs(samples[..., 1]), min=1e-6)
    r = rollout(samples, valid, robot_pos, robot_quat,
                sim_time=0.0, sim_granularity=gen.sim_granularity,
                angular_sim_granularity=gen.angular_sim_granularity,
                min_vel_x=-1.0, min_vel_theta=-1.0, max_vel_x=-1.0,
                max_steps=gen.max_num_steps, sim_time_per_sample=sim_t)
    p = cfg.max_prune_len
    empty_plan = PrunePlan(
        positions=torch.zeros((b, p, 3), device=dev),
        quats=torch.zeros((b, p, 4), device=dev),
        intensity=torch.zeros((b, p), device=dev),
        valid=torch.zeros((b, p), dtype=torch.bool, device=dev),
        count=torch.zeros((b,), dtype=torch.int64, device=dev))
    costs, rejected = score_rollouts(
        dataclasses.replace(cfg.rotate_critics, shortest_angle=None),
        gen.cuboid, r, empty_plan, obstacles, obs_valid,
        torch.zeros((b,), device=dev),
        collision_near_k=cfg.collision_near_k,
        obstacle_chunk=cfg.collision_obstacle_chunk)
    idx, _cost, found = best_trajectory(costs, rejected)
    failed = ~found

    yaw = yaw_from_quat(robot_quat)
    to_180 = torch.abs(shortest_angular_distance(yaw,
                                                 rec.start_yaw + math.pi))
    got_180 = rec.got_180 | (to_180 < tolerance)
    home = torch.abs(shortest_angular_distance(yaw, rec.start_yaw))
    done = got_180 & (home < tolerance)

    w_best = r.samples[..., -1].gather(1, idx[:, None])[:, 0]
    wz = torch.where(found & ~done, w_best, 0.0)
    rec2 = RotateRecoveryState(start_yaw=rec.start_yaw, got_180=got_180,
                               active=rec.active & ~done & ~failed)
    return rec2, wz, done, failed
