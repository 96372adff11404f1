"""A fleet of robots through the local planner.

Counterpart of ``dddmr_navigation_tpu/parallel/fleet.py`` for the fleet
tick and its integrators. The JAX package vmaps the single-robot tick over
the fleet; here the tick is written with a leading robot axis, so one fleet
tick launches each kernel once per critic.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dddmr_navigation_tpu_torch.config import LocalPlannerConfig
from dddmr_navigation_tpu_torch.geometry import (
    yaw_from_quat, quat_from_yaw, quat_multiply)
from dddmr_navigation_tpu_torch.planning.local.planner import (
    GlobalPlan, VelocityCommand, compute_velocity_command)


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
