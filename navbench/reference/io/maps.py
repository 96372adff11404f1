"""Synthetic map generators used by tests and benchmarks.

The port's own copy of ``dddmr_navigation_tpu/io/maps.py`` (numpy only):
``voxel_downsample``, ``flat_ground_map``, ``ramp_ground_map``,
``corridor_map``, ``multi_level_map`` and ``box_obstacle``.

The reference ships demo PCD maps (`dddmr_perception_3d/map/ground.pcd`,
`map.pcd`) and a 2D-occupancy→ground generator (`occupancy2ground.cpp`); we
generate equivalent synthetic grounds procedurally: flat floors, ramps, and
wall-lined corridors — matching BASELINE.json's benchmark configs
("flat single-floor recorded map", "ramp/slope map").
"""
from __future__ import annotations

import numpy as np


def voxel_downsample(points: np.ndarray, leaf: float) -> np.ndarray:
    """Voxel-grid downsample (centroid per occupied voxel), mirroring
    pcl::VoxelGrid semantics used throughout the reference."""
    if len(points) == 0:
        return points
    keys = np.floor(points[:, :3] / leaf).astype(np.int64)
    # Unique voxels -> centroid of member points.
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((counts.shape[0], points.shape[1]), dtype=np.float64)
    np.add.at(sums, inv, points)
    return (sums / counts[:, None]).astype(np.float32)


def flat_ground_map(size_x: float = 20.0, size_y: float = 20.0,
                    resolution: float = 0.25, z: float = 0.0) -> np.ndarray:
    """A flat rectangular ground cloud centered at the origin (N,3)."""
    xs = np.arange(-size_x / 2, size_x / 2 + 1e-6, resolution)
    ys = np.arange(-size_y / 2, size_y / 2 + 1e-6, resolution)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    gz = np.full_like(gx, z)
    return np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1).astype(np.float32)


def ramp_ground_map(size_x: float = 30.0, size_y: float = 8.0,
                    resolution: float = 0.25, ramp_start: float = 5.0,
                    ramp_end: float = 15.0, height: float = 2.0) -> np.ndarray:
    """Flat → ramp → upper floor along +x (the reference's multi-level use
    case; BASELINE config 2)."""
    xs = np.arange(-size_x / 2, size_x / 2 + 1e-6, resolution)
    ys = np.arange(-size_y / 2, size_y / 2 + 1e-6, resolution)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    t = np.clip((gx - ramp_start) / max(ramp_end - ramp_start, 1e-6), 0.0, 1.0)
    gz = t * height
    return np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1).astype(np.float32)


def corridor_map(length: float = 20.0, width: float = 4.0,
                 resolution: float = 0.25, wall_height: float = 2.0):
    """Corridor along +x: returns (ground, walls) clouds. Walls become the
    static map cloud (obstacles above ground), as occupancy2ground extrudes
    (`occupancy2ground.cpp:60-250`)."""
    ground = flat_ground_map(length, width, resolution)
    xs = np.arange(-length / 2, length / 2 + 1e-6, resolution)
    zs = np.arange(0.0, wall_height + 1e-6, resolution)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    wall_y = width / 2
    left = np.stack([gx.ravel(), np.full(gx.size, wall_y), gz.ravel()], axis=1)
    right = np.stack([gx.ravel(), np.full(gx.size, -wall_y), gz.ravel()], axis=1)
    walls = np.concatenate([left, right]).astype(np.float32)
    return ground, walls


def multi_level_map(resolution: float = 0.25, clearance: float = 2.5,
                    floor_x: float = 10.0, floor_y: float = 8.0,
                    ramp_width: float = 2.5,
                    duct_height: float = 0.6):
    """Two STACKED floors joined by a side ramp, with a low overhang duct —
    the go2 beginner-guide multi-level world's stress profile
    (`src/dddmr_beginner_guide/README.md:9-60`): nodes at the same XY on
    different z levels (z-disambiguation), a static-layer overhang lethal
    region (`static_layer.cpp:201-231` z-passthrough), and a cross-floor
    goal only reachable via the ramp.

    Layout (top view; ramp climbs toward -x along the north band):

        y=floor_y+ramp_width  ┌────────── ramp (z: 2.5 → 0) ─────────┐
        y=floor_y             ├──────────────────────────────────────┤
                              │  floor A (z=0)  +  floor B (z=2.5)   │
                              │  duct slab over A at x∈[4,6],y∈[0,4] │
        y=0                   └──────────────────────────────────────┘
                              x=0                                x=10

    Returns ``(ground, map_pts)``: the stacked ground cloud (floor A +
    floor B + ramp) and the structure cloud (duct slab + floor B underside
    + ramp underside) used for overhang/static tests.
    """
    xs = np.arange(0.0, floor_x + 1e-6, resolution)
    ys = np.arange(0.0, floor_y + 1e-6, resolution)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    floor_a = np.stack([gx.ravel(), gy.ravel(),
                        np.zeros(gx.size)], 1)
    floor_b = np.stack([gx.ravel(), gy.ravel(),
                        np.full(gx.size, clearance)], 1)
    # ramp band north of the floors, climbing toward -x: touches floor A
    # at (x≈floor_x, z=0) and floor B at (x≈0, z=clearance)
    rys = np.arange(floor_y + resolution,
                    floor_y + ramp_width + 1e-6, resolution)
    rgx, rgy = np.meshgrid(xs, rys, indexing="ij")
    rz = (floor_x - rgx.ravel()) / floor_x * clearance
    ramp = np.stack([rgx.ravel(), rgy.ravel(), rz], 1)
    ground = np.concatenate([floor_a, floor_b, ramp]).astype(np.float32)

    # structure cloud: a low duct slab over floor A (overhang lethal:
    # inside the z+0.1..z+1.0 passthrough box) + the floor B / ramp
    # undersides (clearance > 1 m ⇒ NOT lethal)
    dxs = np.arange(4.0, 6.0 + 1e-6, 0.1)
    dys = np.arange(0.0, 4.0 + 1e-6, 0.1)
    dgx, dgy = np.meshgrid(dxs, dys, indexing="ij")
    duct = np.stack([dgx.ravel(), dgy.ravel(),
                     np.full(dgx.size, duct_height)], 1)
    map_pts = np.concatenate([
        duct, floor_b - [0.0, 0.0, 0.05], ramp - [0.0, 0.0, 0.05],
    ]).astype(np.float32)
    return ground, map_pts


def box_obstacle(center, size=(0.5, 0.5, 1.0), resolution: float = 0.1) -> np.ndarray:
    """Dense point-sampled box obstacle (like `dummy_pc_pub`'s synthetic
    wall, `test/dummy_pc_pub.cpp:33-70`)."""
    cx, cy, cz = center
    sx, sy, sz = size
    xs = np.arange(-sx / 2, sx / 2 + 1e-6, resolution)
    ys = np.arange(-sy / 2, sy / 2 + 1e-6, resolution)
    zs = np.arange(0.0, sz + 1e-6, resolution)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    pts = np.stack([gx.ravel() + cx, gy.ravel() + cy, gz.ravel() + cz], axis=1)
    return pts.astype(np.float32)
