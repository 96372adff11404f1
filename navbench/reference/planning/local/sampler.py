"""Velocity-sample generation (the DWA dynamic window), batched over robots.

Counterpart of ``dddmr_navigation_tpu/planning/local/sampler.py``: the
differential-drive generator (`dd_simple_trajectory_generator_theory.cpp:
236-312`, `velocity_iterator.h:42-66`), the omni generator
(`omni_simple_trajectory_generator_theory.cpp:259-332`) and the
rotate-in-place generator (`dd_rotate_inplace_theory.cpp:229-276`). Every
function takes a leading robot axis B.
"""
from __future__ import annotations

import torch

from navbench.reference.config import (
    DDRotateInplaceConfig, DDSimpleGeneratorConfig, OmniSimpleGeneratorConfig,
    TrajectoryGeneratorLimits)


def velocity_axis_samples(vmin, vmax, num_samples: int):
    """Padded VelocityIterator per robot.

    Args:
      vmin, vmax: (B,) f32 window bounds.

    Returns: (B, n+1) values and valid mask, n = max(2, num_samples), in
    ascending (reference iteration) order with invalid slots last.
    """
    n = max(2, int(num_samples))
    # Rounded as XLA compiles the JAX version: the division by the constant
    # n-1 becomes a multiply by its f32 reciprocal, and vmin + step·j one
    # fused multiply-add, which the f64 sum (exact here) rounded once to
    # f32 reproduces. Samples then match bit for bit.
    step = (vmax - vmin) * (1.0 / (n - 1))
    ar = torch.arange(n, dtype=torch.float64, device=vmin.device)
    base = (vmin[:, None].double() + step[:, None].double() * ar).float()
    base[:, -1] = vmax  # avoid rounding error at max
    degenerate = (vmin == vmax)[:, None]       # single sample at vmin
    valid = torch.where(degenerate, ar == 0, torch.ones_like(degenerate))
    base = torch.where(degenerate, vmin[:, None], base)

    zero_present = (valid & (base == 0.0)).any(dim=1)
    insert_zero = (vmin < 0.0) & (vmax > 0.0) & ~zero_present & ~degenerate[:, 0]
    vals = torch.cat([base, torch.zeros_like(base[:, :1])], dim=1)
    mask = torch.cat([valid, insert_zero[:, None]], dim=1)
    # Ascending, invalid slots last; stable, as jnp.argsort is, for ties.
    key = torch.where(mask, vals, torch.inf)
    order = torch.sort(key, dim=1, stable=True).indices
    return vals.gather(1, order), mask.gather(1, order)


def motor_constraint_ok(limits: TrajectoryGeneratorLimits, vx, w):
    """`isMotorConstraintSatisfied` (`dd_simple_...cpp:297-312`)."""
    if not limits.use_motor_constraint:
        return torch.ones(torch.broadcast_shapes(vx.shape, w.shape),
                          dtype=torch.bool, device=vx.device)
    vr = vx + limits.robot_radius * w
    vl = vx - limits.robot_radius * w
    k = limits.gear_ratio * 60.0 / 3.1415926 / limits.wheel_diameter
    return (torch.abs(vr * k) < limits.max_motor_shaft_rpm) & (
        torch.abs(vl * k) < limits.max_motor_shaft_rpm)


def dd_simple_samples(cfg: DDSimpleGeneratorConfig, v_now, w_now,
                      allowed_max_speed):
    """The (vx, ω) sample grid for each robot's current state.

    Args:
      v_now, w_now: (B,) current linear/angular velocity.
      allowed_max_speed: (B,) perception speed limit (≤0 means unlimited).

    Returns:
      samples: (B, S, 2) f32 [vx, ω], S = (nx+1)*(nw+1) padded slots,
        vx-major then ω (reference loop order).
      valid: (B, S) bool.
    """
    lim = cfg.limits
    sim_period = 1.0 / cfg.controller_frequency

    max_vx_cap = torch.where(allowed_max_speed > 0.0,
                             torch.clamp(allowed_max_speed, max=lim.max_vel_x),
                             torch.full_like(allowed_max_speed, lim.max_vel_x))
    max_vx = torch.minimum(max_vx_cap, v_now + lim.acc_lim_x * sim_period)
    min_vx = torch.clamp(v_now / lim.deceleration_ratio, min=lim.min_vel_x)
    inverted = max_vx < min_vx
    collapsed = v_now / lim.deceleration_ratio
    min_vx = torch.where(inverted, collapsed, min_vx)
    max_vx = torch.where(inverted, collapsed, max_vx)

    max_w = torch.clamp(w_now + lim.acc_lim_theta * sim_period,
                        max=lim.max_vel_theta)
    min_w = torch.clamp(w_now - lim.acc_lim_theta * sim_period,
                        min=-lim.max_vel_theta)

    vx_vals, vx_mask = velocity_axis_samples(min_vx, max_vx, cfg.linear_x_sample)
    w_vals, w_mask = velocity_axis_samples(min_w, max_w, cfg.angular_z_sample)

    nx, nw = vx_vals.shape[1], w_vals.shape[1]
    vx_g = vx_vals.repeat_interleave(nw, dim=1)
    w_g = w_vals.repeat(1, nx)
    mask = vx_mask.repeat_interleave(nw, dim=1) & w_mask.repeat(1, nx)
    mask = mask & motor_constraint_ok(lim, vx_g, w_g)
    return torch.stack([vx_g, w_g], dim=-1), mask


def _omni_axis_window(v_now, vmin_lim, vmax_lim, acc, sim_period, decel):
    """One linear-axis dynamic window of the omni sampler
    (`omni_simple_trajectory_generator_theory.cpp:283-309`): ±acc·T around
    v_now, with the deceleration_ratio branch when the robot rides a speed
    extreme. v_now (B,); returns (vmin, vmax), each (B,)."""
    vmax = torch.clamp(v_now + acc * sim_period, max=vmax_lim)
    vmin = torch.clamp(v_now - acc * sim_period, min=vmin_lim)
    at_max = v_now >= vmax_lim / decel
    at_min = v_now <= vmin_lim / decel
    vmin = torch.where(at_max, torch.clamp(v_now / decel, min=vmin_lim), vmin)
    vmax = torch.where(~at_max & at_min,
                       torch.clamp(v_now / decel, max=vmax_lim), vmax)
    return vmin, vmax


def omni_simple_samples(cfg: OmniSimpleGeneratorConfig, v_now, vy_now, w_now):
    """The (vx, vy, ω) sample grid for each robot's current state
    (`OmniSimpleTrajectoryGeneratorTheory::initialise`). The reference's
    omni motor constraint always passes (`:334-343`), so no RPM gate.

    Returns: samples (B, S, 3) [vx, vy, ω], S = (nx+1)(ny+1)(nw+1) padded
    slots, vx-major then vy then ω; valid (B, S).
    """
    lim = cfg.limits
    sim_period = 1.0 / cfg.controller_frequency
    min_vx, max_vx = _omni_axis_window(
        v_now, lim.min_vel_x, lim.max_vel_x, lim.acc_lim_x, sim_period,
        lim.deceleration_ratio)
    min_vy, max_vy = _omni_axis_window(
        vy_now, lim.min_vel_y, lim.max_vel_y, lim.acc_lim_y, sim_period,
        lim.deceleration_ratio)
    max_w = torch.clamp(w_now + lim.acc_lim_theta * sim_period,
                        max=lim.max_vel_theta)
    min_w = torch.clamp(w_now - lim.acc_lim_theta * sim_period,
                        min=-lim.max_vel_theta)

    vx_vals, vx_mask = velocity_axis_samples(min_vx, max_vx,
                                             cfg.linear_x_sample)
    vy_vals, vy_mask = velocity_axis_samples(min_vy, max_vy,
                                             cfg.linear_y_sample)
    w_vals, w_mask = velocity_axis_samples(min_w, max_w, cfg.angular_z_sample)

    nx, ny, nw = vx_vals.shape[1], vy_vals.shape[1], w_vals.shape[1]

    def grid(vals, inner, outer):
        return vals.repeat_interleave(inner, dim=1).repeat(1, outer)

    vx_g, vy_g, w_g = (grid(vx_vals, ny * nw, 1), grid(vy_vals, nw, nx),
                       grid(w_vals, 1, nx * ny))
    mask = (grid(vx_mask, ny * nw, 1) & grid(vy_mask, nw, nx)
            & grid(w_mask, 1, nx * ny))
    return torch.stack([vx_g, vy_g, w_g], dim=-1), mask


def rotate_inplace_samples(cfg: DDRotateInplaceConfig,
                           limits: TrajectoryGeneratorLimits, b: int,
                           device):
    """±rotation_speed for each of ``b`` robots, motor-gated
    (`dd_rotate_inplace_theory.cpp:259-268`). Returns ((B, 2, 2) [vx, ω],
    (B, 2) valid)."""
    vx = torch.zeros((b, 2), device=device)
    w = torch.stack([vx[:, 0] + cfg.rotation_speed,
                     vx[:, 1] - cfg.rotation_speed], dim=1)
    return torch.stack([vx, w], dim=-1), motor_constraint_ok(limits, vx, w)
