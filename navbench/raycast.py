"""Spinning-lidar sweeps ray-cast on the device, many poses at once.

The arithmetic of the port's ``utils/lidar_sim.py::simulate_scan`` (a
ground plane and axis-aligned boxes, ring-major rays from ``v_bottom`` to
``v_top``, the sensor's yaw added to the azimuths and taken off the
points), batched over poses and frozen here with the benchmark. Besides
static boxes, each pose may carry boxes of its own (other robots' bodies
at that tick).
"""
from __future__ import annotations

import math

import torch

# Rays cast in one pass: bounds the temporaries of a batch of sweeps
# (some hundreds of MB) whatever the robots and rays of a cell.
RAYS_PER_PASS = 1 << 21


def ray_dirs(rings: int, cols: int, v_bottom: float, v_top: float,
             device) -> tuple:
    """(elevation (R,), azimuth (C,)) of one sweep's rays, in radians."""
    if rings > 1:
        elev = torch.linspace(math.radians(v_bottom), math.radians(v_top),
                              rings, dtype=torch.float64, device=device)
    else:
        elev = torch.zeros((1,), dtype=torch.float64, device=device)
    azim = (torch.arange(cols, dtype=torch.float64, device=device)
            * (2.0 * math.pi / cols) - math.pi)
    return elev, azim


def _slab(origin, inv, lo, hi):
    """Entry distance of rays into boxes (inf = miss). ``origin`` (P, 1, 3)
    against ``inv`` (P, N, 3) = 1 / direction, boxes ``lo``/``hi``
    broadcastable to (P, 1, 3)."""
    t0 = (lo - origin) * inv
    t1 = (hi - origin) * inv
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    tmin = torch.clamp(tmin, min=1e-6)
    return torch.where(tmax >= tmin, tmin, torch.inf)


def cast(sensor_pos, yaw, rings: int, cols: int, v_bottom: float,
         v_top: float, max_range: float, static_boxes, pose_boxes=None,
         ground_z: float = 0.0):
    """Sweeps from ``sensor_pos`` (P, 3) with ``yaw`` (P,), all f32 on one
    device; ``static_boxes`` (S, 2, 3) and ``pose_boxes`` (P, Q, 2, 3) or
    None (a box whose corners are equal is no box). Returns (points
    (P, R·C, 3) in each sensor's frame with its yaw taken off, world z of
    each return (P, R·C), hit mask (P, R·C))."""
    dev = sensor_pos.device
    elev, azim = ray_dirs(rings, cols, v_bottom, v_top, dev)
    a = azim[None, None, :] + yaw.double()[:, None, None]      # (P, 1, C)
    ce, se = torch.cos(elev)[None, :, None], torch.sin(elev)[None, :, None]
    dirs = torch.stack(torch.broadcast_tensors(
        ce * torch.cos(a), ce * torch.sin(a), se.expand(1, rings, 1)),
        dim=-1).reshape(sensor_pos.shape[0], -1, 3).float()  # (P, N, 3)
    tiny = torch.full_like(dirs, 1e-30)
    safe = torch.where(dirs == 0, torch.copysign(tiny, dirs), dirs)
    inv = 1.0 / safe
    origin = sensor_pos[:, None, :]

    t = torch.full(dirs.shape[:2], torch.inf, device=dev)
    dz = dirs[..., 2]
    tg = (ground_z - origin[..., 2]) / torch.where(dz == 0, -1e-30, dz)
    t = torch.where((dz < -1e-6) & (tg > 1e-6), torch.minimum(t, tg), t)
    for lo, hi in static_boxes:
        t = torch.minimum(t, _slab(origin, inv, lo, hi))
    if pose_boxes is not None:
        for q in range(pose_boxes.shape[1]):
            lo = pose_boxes[:, q, 0][:, None, :]
            hi = pose_boxes[:, q, 1][:, None, :]
            hit = _slab(origin, inv, lo, hi)
            empty = (hi <= lo).any(dim=-1)                      # (P, 1)
            t = torch.minimum(t, torch.where(empty, torch.inf, hit))

    mask = torch.isfinite(t) & (t <= max_range)
    t = torch.where(mask, t, 0.0)
    world = dirs * t[..., None]
    c, s = torch.cos(-yaw)[:, None], torch.sin(-yaw)[:, None]
    pts = torch.stack([c * world[..., 0] - s * world[..., 1],
                       s * world[..., 0] + c * world[..., 1],
                       world[..., 2]], dim=-1)
    return pts, world[..., 2] + origin[..., 2], mask
