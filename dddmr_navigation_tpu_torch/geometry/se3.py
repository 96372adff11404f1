"""Quaternion math on tensors, the counterpart of
``dddmr_navigation_tpu/geometry/se3.py`` for the functions the ported ticks
use.

Quaternions are ``(x, y, z, w)`` (tf2 layout). Every function broadcasts over
leading batch dimensions and keeps the operation order of the JAX version, so
that the two agree to the last few ulps.
"""
from __future__ import annotations

import torch

from dddmr_navigation_tpu_torch.rounding import fma, fma_norm


def quat_normalize(q):
    """q / ‖q‖; the norm rounded as the jitted ``jnp.linalg.norm`` (an FMA
    chain, then a correctly rounded square root)."""
    return q / fma_norm(q)[..., None]


def quat_multiply(q1, q2):
    """Hamilton product (tf2 ``q1*q2``: rotate by q2 first, then q1)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def quat_conjugate(q):
    """(-x, -y, -z, w), without a copy of constants to the device."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def quat_from_axis_angle(axis, angle):
    """tf2::Quaternion(axis, angle); the axis need not be normalized."""
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    half = angle[..., None] * 0.5
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def quat_from_rpy(roll, pitch, yaw):
    """tf2 setRPY: R_z(yaw) * R_y(pitch) * R_x(roll)."""
    hr, hp, hy = roll * 0.5, pitch * 0.5, yaw * 0.5
    cr, sr = torch.cos(hr), torch.sin(hr)
    cp, sp = torch.cos(hp), torch.sin(hp)
    cy, sy = torch.cos(hy), torch.sin(hy)
    return torch.stack(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ],
        dim=-1,
    )


def quat_from_yaw(yaw):
    z = torch.zeros_like(yaw)
    return quat_from_rpy(z, z, yaw)


def yaw_from_quat(q):
    """Yaw (rotation about z), as tf2 getEulerYPR gives it."""
    x, y, z, w = q.unbind(-1)
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def rpy_from_quat(q):
    """(roll, pitch, yaw) as tf2 Matrix3x3::getEulerYPR gives them."""
    x, y, z, w = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return roll, pitch, yaw


def normalize_angle(a):
    """Wrap to (-pi, pi]."""
    return torch.atan2(torch.sin(a), torch.cos(a))


def shortest_angular_distance(a_from, a_to):
    return normalize_angle(a_to - a_from)


def slope_aware_quat(v):
    """Orientation of a path segment with direction v (..., 3), as the
    global planner builds it (``global_planner.cpp:334-363``): an
    axis-angle quaternion about normalize(v) x (1,0,0) when vz != 0, a pure
    yaw atan2(vy, vx) otherwise."""
    vx, vy, vz = v.unbind(-1)
    unit = torch.linalg.norm(v, dim=-1)
    unit = torch.where(unit < 1e-9, torch.ones_like(unit), unit)
    axis_vec = v / unit[..., None]
    up = torch.zeros_like(v)
    up[..., 0] = 1.0
    right = torch.linalg.cross(axis_vec, up, dim=-1)
    right_norm = torch.linalg.norm(right, dim=-1, keepdim=True)
    z_axis = torch.zeros_like(right)
    z_axis[..., 2] = 1.0
    safe_right = torch.where(right_norm < 1e-9, z_axis, right)
    ang = -torch.acos(torch.clamp(axis_vec[..., 0], -1.0, 1.0))
    q_slope = quat_from_axis_angle(safe_right, ang)
    q_flat = quat_from_yaw(torch.atan2(vy, vx))
    return torch.where((vz != 0.0)[..., None], q_slope, q_flat)


def quat_rotate_fma(q, v):
    """:func:`quat_rotate` rounded as the JAX package's jitted quat_rotate
    is on the CPU: v + w·t as one fused multiply-add, the cross products
    as fma(a1, b2, -(a2·b1)). The perception stages voxelize rotated scan
    points, so an ulp there can move a point into the next voxel; this
    keeps the port's voxels the JAX package's."""
    qv, qw = q[..., :3], q[..., 3:4]
    qv = qv.expand(torch.broadcast_shapes(qv.shape, v.shape))
    t = 2.0 * _cross_fma(qv, v)
    return fma(qw, t, v) + _cross_fma(qv, t)


def quat_inverse_rotate_fma(q, v):
    """Rotate vector(s) v by the inverse of quaternion(s) q, rounded as the
    JAX package's jitted ``quat_inverse_rotate`` is on the CPU
    (:func:`quat_rotate_fma` of the conjugate). The depth layer bins
    camera-frame directions from it."""
    return quat_rotate_fma(quat_conjugate(q), v)


def quat_multiply_fma(q1, q2):
    """:func:`quat_multiply` rounded as the JAX package's jitted
    quat_multiply is on the CPU: each component a chain of fused
    multiply-adds starting from w1's product (``fma(w1, x2, x1·w2)``, then
    the remaining products in order). MCL looks up correspondence cells
    from poses composed with it, so an ulp there can move a cell."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        fma(-z1, y2, fma(y1, z2, fma(w1, x2, x1 * w2))),
        fma(z1, x2, fma(y1, w2, fma(w1, y2, -(x1 * z2)))),
        fma(z1, w2, fma(-y1, x2, fma(w1, z2, x1 * y2))),
        fma(-z1, z2, fma(-y1, y2, fma(w1, w2, -(x1 * x2)))),
    ], dim=-1)


def _cross_fma(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([fma(a1, b2, -(a2 * b1)), fma(a2, b0, -(a0 * b2)),
                        fma(a0, b1, -(a1 * b0))], dim=-1)
