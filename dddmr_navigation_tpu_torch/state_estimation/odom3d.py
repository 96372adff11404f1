"""3D odometry fusion, the counterpart of
``dddmr_navigation_tpu/state_estimation/odom3d.py`` (the reference's
``dddmr_odom_3d``, `src/dddmr_odom_3d/src/odom_3d_example.cpp:35-110`).

Wheel-odometry linear velocity × IMU orientation → 3D odometry:

    x += v·cos(pitch)·cos(yaw)·dt
    y += v·cos(pitch)·sin(yaw)·dt
    z += v·sin(−pitch)·dt

with the orientation taken straight from the IMU quaternion. The JAX
package integrates a log with ``lax.scan``; here :func:`integrate_log`
loops over the steps and adds each one to the running position in turn,
as the scan does (a ``cumsum`` would round differently). Roll, pitch and
yaw come from the quaternion with XLA-on-the-CPU's ``atan2``/``asin``
(``rounding.atan2_xla``/``asin_xla``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dddmr_navigation_tpu_torch.rounding import asin_xla, atan2_xla


class Odom3DState(NamedTuple):
    pos: torch.Tensor   # (..., 3)
    quat: torch.Tensor  # (..., 4) latest IMU orientation


def init_odom3d(device="cuda") -> Odom3DState:
    return Odom3DState(
        pos=torch.zeros((3,), device=device),
        quat=torch.tensor([0.0, 0.0, 0.0, 1.0], device=device))


def _pitch_yaw(q):
    """Pitch and yaw as tf2's getEulerYPR gives them."""
    x, y, z, w = q.unbind(-1)
    pitch = asin_xla(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = atan2_xla(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return pitch, yaw


def odom3d_step(state: Odom3DState, v_linear, imu_quat, dt) -> Odom3DState:
    """One fusion step (`odom_3d_example.cpp:93-96`)."""
    pitch, yaw = _pitch_yaw(imu_quat)
    dx = v_linear * torch.cos(pitch) * torch.cos(yaw) * dt
    dy = v_linear * torch.cos(pitch) * torch.sin(yaw) * dt
    dz = v_linear * torch.sin(-pitch) * dt
    return Odom3DState(pos=state.pos + torch.stack([dx, dy, dz], dim=-1),
                       quat=imu_quat)


def integrate_log(state: Odom3DState, v_linear_seq, imu_quat_seq, dt_seq):
    """Integrate a recorded log of T ≥ 1 steps (velocities (T,),
    quaternions (T, 4), time steps (T,)): returns (final state, (T, 3)
    path). The steps' increments are computed at once; only the running
    sum is a loop."""
    pitch, yaw = _pitch_yaw(imu_quat_seq)
    d = torch.stack([v_linear_seq * torch.cos(pitch) * torch.cos(yaw)
                     * dt_seq,
                     v_linear_seq * torch.cos(pitch) * torch.sin(yaw)
                     * dt_seq,
                     v_linear_seq * torch.sin(-pitch) * dt_seq], dim=-1)
    pos, path = state.pos, []
    for t in range(d.shape[0]):
        pos = pos + d[t]
        path.append(pos)
    return Odom3DState(pos=pos, quat=imu_quat_seq[-1]), torch.stack(path)
