"""Batched trajectory rollout for a fleet: the reference's per-sample Euler
loop (`dd_simple_trajectory_generator_theory.cpp:351-464`) in closed form.

Counterpart of ``dddmr_navigation_tpu/planning/local/rollout.py``: the
differential-drive and rotate-in-place layout [vx, ω], and the omni layout
[vx, vy, ω] (`omni_simple_trajectory_generator_theory.cpp:494-510`). Every
tensor carries a leading robot axis B.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from navbench.reference.geometry import (
    quat_rotate, quat_multiply, quat_from_yaw)


class Rollouts(NamedTuple):
    """Batched rollout results. S = samples, N = max steps."""
    samples: torch.Tensor      # (B, S, 2) [vx, ω] or (B, S, 3) [vx, vy, ω]
    valid: torch.Tensor        # (B, S) trajectory validity
    step_valid: torch.Tensor   # (B, S, N) per-step validity
    positions: torch.Tensor    # (B, S, N, 3) global positions
    theta: torch.Tensor        # (B, S, N) robot-frame accumulated heading
    num_steps: torch.Tensor    # (B, S) int64
    dt: torch.Tensor           # (B, S) per-sample timestep
    robot_pos: torch.Tensor    # (B, 3)
    robot_quat: torch.Tensor   # (B, 4)


def rollout(samples, sample_valid, robot_pos, robot_quat, *,
            sim_time: float, sim_granularity: float,
            angular_sim_granularity: float, min_vel_x: float,
            min_vel_theta: float, max_vel_x: float,
            max_steps: int, sim_time_per_sample=None) -> Rollouts:
    """Roll out every robot's velocity samples.

    Args:
      samples: (B, S, 2) [vx, ω], or (B, S, 3) [vx, vy, ω] (omni: the
        validity gates act on hypot(vx, vy)).
      sample_valid: (B, S) bool.
      robot_pos, robot_quat: (B, 3), (B, 4) robot poses in the global frame.
      sim_time_per_sample: optional (B, S) horizon in place of
        ``sim_time`` (the rotate generator's 6.28/|ω|,
        `dd_rotate_inplace_theory.cpp:330`).
    """
    omni = samples.shape[-1] == 3
    vx = samples[..., 0]
    vy = samples[..., 1] if omni else None
    w = samples[..., -1]
    vmag = torch.hypot(vx, vy) if omni else torch.abs(vx)
    eps = 1e-4
    T = (torch.full_like(vx, sim_time) if sim_time_per_sample is None
         else sim_time_per_sample)

    # validity gates (generateTrajectory early returns)
    too_slow = torch.ones_like(vx, dtype=torch.bool)
    if min_vel_x >= 0:
        too_slow = too_slow & (vmag + eps < min_vel_x)
    else:
        too_slow = torch.zeros_like(too_slow)
    if min_vel_theta >= 0:
        too_slow = too_slow & (torch.abs(w) + eps < min_vel_theta)
    else:
        too_slow = torch.zeros_like(too_slow)
    too_fast = ((vmag - eps > max_vel_x) if max_vel_x >= 0
                else torch.zeros_like(too_slow))

    num_steps = torch.ceil(torch.maximum(
        vmag * T / sim_granularity,
        torch.abs(w) * T / angular_sim_granularity)).long()
    num_steps = torch.clamp(num_steps, max=max_steps)
    valid = sample_valid & ~too_slow & ~too_fast & (num_steps > 0)

    dt = T / torch.clamp(num_steps, min=1).float()

    # Closed-form Euler: the update uses the *previous* heading, so
    # θ_k = k·ω·dt and x_k = v·dt·Σ_{j<k} cos(θ_j). PyTorch's cumsum and
    # sin/cos round differently from XLA's at the ulp level only.
    j = torch.arange(max_steps, dtype=torch.float32, device=samples.device)
    wdt = (w * dt)[..., None]
    th_pre = j * wdt                                         # (B, S, N)
    cos_c = torch.cumsum(torch.cos(th_pre), dim=-1)
    sin_c = torch.cumsum(torch.sin(th_pre), dim=-1)
    vdt = (vx * dt)[..., None]
    xs = vdt * cos_c
    ys = vdt * sin_c
    if omni:            # vy rotated +90° (`omni_simple_...cpp:499-505`)
        vydt = (vy * dt)[..., None]
        xs = xs - vydt * sin_c
        ys = ys + vydt * cos_c
    ths = (j + 1.0) * wdt                                    # θ after step k

    local = torch.stack([xs, ys, torch.zeros_like(xs)], dim=-1)  # (B,S,N,3)
    positions = (quat_rotate(robot_quat[:, None, None, :], local)
                 + robot_pos[:, None, None, :])

    step_idx = torch.arange(max_steps, device=samples.device)
    step_valid = valid[..., None] & (step_idx < num_steps[..., None])

    return Rollouts(
        samples=samples, valid=valid, step_valid=step_valid,
        positions=positions, theta=ths, num_steps=num_steps, dt=dt,
        robot_pos=robot_pos, robot_quat=robot_quat)


def end_indices(r: Rollouts):
    """(B, S) index of the last valid step (num_steps-1, clamped)."""
    return torch.clamp(r.num_steps - 1, 0, r.positions.shape[2] - 1)


def end_positions(r: Rollouts):
    """(B, S, 3) position at the last step. A gather, where the JAX
    package takes a one-hot product: both are exact."""
    idx = end_indices(r)[..., None, None].expand(-1, -1, 1, 3)
    return r.positions.gather(2, idx)[:, :, 0]


def end_quats(r: Rollouts):
    """(B, S, 4) global orientation at the last step: robot_quat ∘ Rz(θ_end)."""
    th_end = r.theta.gather(2, end_indices(r)[..., None])[..., 0]
    return quat_multiply(r.robot_quat[:, None, :], quat_from_yaw(th_end))
