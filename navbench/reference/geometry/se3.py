"""Quaternion and SE(3) math on tensors, the counterpart of
``dddmr_navigation_tpu/geometry/se3.py``.

Quaternions are ``(x, y, z, w)`` (tf2 layout); poses are ``(translation[3],
quaternion[4])`` tuples. Every function broadcasts over leading batch
dimensions and keeps the operation order of the JAX version, so that the two
agree to the last few ulps. The ``*_fma`` variants round as the JAX
package's jitted versions do on the CPU, where a threshold follows.
"""
from __future__ import annotations

import torch

from navbench.reference.rounding import fma, fma_norm


def quat_identity(dtype=torch.float32, device="cuda"):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


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


def quat_inverse_rotate(q, v):
    return quat_rotate(quat_conjugate(q), v)


def quat_from_axis_angle(axis, angle):
    """tf2::Quaternion(axis, angle); the axis need not be normalized."""
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    half = angle[..., None] * 0.5
    return torch.cat([axis * torch.sin(half), torch.cos(half)], dim=-1)


def quat_exp(w):
    """Rotation-vector exponential → quaternion, smooth at ‖w‖ = 0: the
    series branch keeps the derivative exact there, where the Gauss-Newton
    solvers linearize (``torch.func.jacfwd`` at ξ = 0)."""
    ang2 = torch.sum(w * w, dim=-1, keepdim=True)
    ang = torch.sqrt(ang2 + 1e-16)
    half = 0.5 * ang
    k = torch.where(ang2 > 1e-12, torch.sin(half) / ang, 0.5 - ang2 / 48.0)
    return torch.cat([w * k, torch.cos(half)], dim=-1)


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


def quat_to_matrix(q):
    """3×3 rotation matrix from quaternion, batched."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """Quaternion (x,y,z,w) from rotation matrix: the four Shepperd
    candidates, the numerically best selected without a branch."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def cand(s, parts):
        r = torch.sqrt(torch.clamp(s, min=1e-12)) * 0.5
        return torch.stack(parts(r), -1) / (4.0 * r[..., None])
    q0 = cand(1.0 + tr, lambda r: [m21 - m12, m02 - m20, m10 - m01,
                                   4.0 * r * r])
    q1 = cand(1.0 + m00 - m11 - m22, lambda r: [4.0 * r * r, m01 + m10,
                                                m02 + m20, m21 - m12])
    q2 = cand(1.0 - m00 + m11 - m22, lambda r: [m01 + m10, 4.0 * r * r,
                                                m12 + m21, m02 - m20])
    q3 = cand(1.0 - m00 - m11 + m22, lambda r: [m02 + m20, m12 + m21,
                                                4.0 * r * r, m10 - m01])
    cond0 = tr > 0.0
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = torch.where(
        cond0[..., None], q0,
        torch.where(cond1[..., None], q1,
                    torch.where(cond2[..., None], q2, q3)))
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SE(3) poses: (t[...,3], q[...,4])
# ---------------------------------------------------------------------------

def se3_identity(dtype=torch.float32, device="cuda"):
    return (torch.zeros((3,), dtype=dtype, device=device),
            quat_identity(dtype, device))


def se3_from_xyzq(x, y, z, q):
    return torch.stack([x, y, z], dim=-1), q


def se3_compose(pose_a, pose_b):
    """pose_a ∘ pose_b (apply b in a's frame), like Eigen Affine a*b."""
    ta, qa = pose_a
    tb, qb = pose_b
    return ta + quat_rotate(qa, tb), quat_normalize(quat_multiply(qa, qb))


def se3_inverse(pose):
    t, q = pose
    qi = quat_conjugate(q)
    return -quat_rotate(qi, t), qi


def se3_apply(pose, pts):
    """Transform points (..., 3) by pose; broadcasts over points."""
    t, q = pose
    return quat_rotate(q[..., None, :], pts) + t[..., None, :]


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
    """a × b, each component fma(a1, b2, -(a2·b1)) (and its cyclic
    shifts), the three computed at once: rolling the last axis by -1 gives
    (a1, a2, a0), by 1 gives (a2, a0, a1)."""
    a, b = torch.broadcast_tensors(a, b)
    return fma(torch.roll(a, -1, -1), torch.roll(b, 1, -1),
               -(torch.roll(a, 1, -1) * torch.roll(b, -1, -1)))
