"""Synthetic spinning-lidar simulator over a box world.

Test/bench fixture standing in for the reference's recorded bags and the
Gazebo go2 sim (SURVEY.md §4): analytic ray casting against a ground
plane and a set of axis-aligned boxes (walls, pillars) produces
ring-structured scans shaped like the reference's 16-line lidars.
Host-side NumPy — fixtures, not the compute path. The port's own copy of
``dddmr_navigation_tpu/utils/lidar_sim.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class BoxWorld:
    """Ground plane at z=0 + axis-aligned boxes [(min_xyz, max_xyz)]."""
    boxes: list = field(default_factory=list)
    ground_z: float = 0.0

    def add_box(self, mn, mx):
        self.boxes.append((np.asarray(mn, np.float32),
                           np.asarray(mx, np.float32)))
        return self

    @staticmethod
    def room(half: float = 8.0, wall_h: float = 2.5, thick: float = 0.2):
        """A closed square room with four walls."""
        w = BoxWorld()
        w.add_box([-half - thick, -half - thick, 0], [half + thick, -half, wall_h])
        w.add_box([-half - thick, half, 0], [half + thick, half + thick, wall_h])
        w.add_box([-half - thick, -half, 0], [-half, half, wall_h])
        w.add_box([half, -half, 0], [half + thick, half, wall_h])
        return w


def _ray_box(origin, dirs, mn, mx):
    """Slab test: (N,) distance to box entry (inf = miss)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = (mn[None, :] - origin[None, :]) / dirs
        t1 = (mx[None, :] - origin[None, :]) / dirs
    tmin = np.nanmax(np.minimum(t0, t1), axis=1)
    tmax = np.nanmin(np.maximum(t0, t1), axis=1)
    hit = (tmax >= np.maximum(tmin, 1e-6))
    return np.where(hit, np.maximum(tmin, 1e-6), np.inf)


def simulate_scan(world: BoxWorld, sensor_pos, sensor_yaw: float = 0.0,
                  n_rings: int = 16, n_cols: int = 1000,
                  v_bottom: float = -15.0, v_top: float = 15.0,
                  max_range: float = 120.0, range_noise: float = 0.0,
                  rng=None):
    """Cast all rays of one sweep. Returns (points (R*C, 3) sensor-frame,
    mask (R*C,)). Ring-major layout like a real driver."""
    sensor_pos = np.asarray(sensor_pos, np.float32)
    elev = np.radians(np.linspace(v_bottom, v_top, n_rings, dtype=np.float32))
    azim = np.linspace(-np.pi, np.pi, n_cols, endpoint=False,
                       dtype=np.float32) + sensor_yaw
    E, A = np.meshgrid(elev, azim, indexing="ij")
    dirs = np.stack([np.cos(E) * np.cos(A), np.cos(E) * np.sin(A),
                     np.sin(E)], axis=-1).reshape(-1, 3)

    t = np.full((len(dirs),), np.inf, np.float32)
    # ground plane
    dz = dirs[:, 2]
    with np.errstate(divide="ignore"):
        tg = (world.ground_z - sensor_pos[2]) / dz
    t = np.where((dz < -1e-6) & (tg > 1e-6), np.minimum(t, tg), t)
    # boxes
    for mn, mx in world.boxes:
        t = np.minimum(t, _ray_box(sensor_pos, dirs, mn, mx))

    mask = np.isfinite(t) & (t <= max_range)
    if range_noise > 0:
        rng = rng or np.random.default_rng(0)
        t = t + rng.normal(0, range_noise, t.shape).astype(np.float32)
    t = np.where(mask, t, 0.0)
    # sensor-frame points with the sensor's yaw removed (the lidar spins in
    # its own frame; world yaw enters through the azimuth sweep above)
    c, s = np.cos(-sensor_yaw), np.sin(-sensor_yaw)
    pts_world_dir = dirs * t[:, None]
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    pts = pts_world_dir @ R.T
    return pts.astype(np.float32), mask
