"""2D occupancy ↔ 3D map clouds.

The port's own copy of ``dddmr_navigation_tpu/io/occupancy.py``, whole
(numpy only): ``read_pgm``, ``occupancy_to_clouds``,
``cloud_to_occupancy``.

The equivalent of
`global_planner/utils/occupancy2ground.cpp:60-250` (occupancy → synthetic
ground/wall clouds, which lets the 3D stack run on plain 2D maps like
`data/warehouse.pgm`) and of
`lego_loam_bor/src/pointcloud2occupancy/pointcloud2occupancy.cpp:49-158`
(map cloud → 2D OccupancyGrid for 2D consumers).

Free cells become ground points on z=0; occupied cells become extruded
wall columns. Includes a minimal PGM (P2/P5) reader for ROS map_server
artifacts.
"""
from __future__ import annotations

import numpy as np


def read_pgm(path: str):
    """Read a P2/P5 PGM → (H, W) uint8."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic not in (b"P2", b"P5"):
            raise ValueError(f"not a PGM: {magic!r}")

        def next_token():
            tok = b""
            while True:
                c = f.read(1)
                if not c:
                    raise ValueError("truncated PGM header")
                if c.isspace():
                    if tok:
                        return tok
                    continue
                if c == b"#":
                    f.readline()
                    continue
                tok += c

        w = int(next_token())
        h = int(next_token())
        maxval = int(next_token())
        if magic == b"P5":
            data = np.frombuffer(f.read(w * h), np.uint8, count=w * h)
        else:
            data = np.loadtxt(f, dtype=np.int64).reshape(-1)[: w * h]
        img = data.reshape(h, w).astype(np.float32) / maxval * 255
        return img.astype(np.uint8)


def occupancy_to_clouds(grid: np.ndarray, resolution: float = 0.05,
                        origin=(0.0, 0.0), occupied_thresh: float = 0.65,
                        free_thresh: float = 0.196, wall_height: float = 1.5,
                        wall_step: float = 0.25, negate: bool = False):
    """Occupancy image (map_server convention: white=free, black=occupied)
    → (ground_pts (Gf, 3), wall_pts (W, 3)).

    Matches the reference util's output contract: `mapground` = one point
    per free cell at z=0, `mapcloud` = occupied cells extruded into
    columns so the 3D perception/planner stack treats walls as lethal.
    """
    img = grid.astype(np.float32) / 255.0
    occ_p = img if negate else 1.0 - img        # occupancy probability
    h, w = occ_p.shape
    ys, xs = np.mgrid[0:h, 0:w]
    # map_server: row 0 is the TOP of the map; world y grows upward
    wx = origin[0] + (xs + 0.5) * resolution
    wy = origin[1] + (h - 1 - ys + 0.5) * resolution

    free = occ_p < free_thresh
    occ = occ_p > occupied_thresh
    ground = np.stack([wx[free], wy[free], np.zeros(int(free.sum()))],
                      axis=1).astype(np.float32)
    zs = np.arange(0.0, wall_height + 1e-6, wall_step, dtype=np.float32)
    ox, oy = wx[occ], wy[occ]
    wall = np.concatenate([
        np.stack([ox, oy, np.full_like(ox, z)], axis=1) for z in zs
    ]).astype(np.float32) if len(ox) else np.zeros((0, 3), np.float32)
    return ground, wall


def cloud_to_occupancy(points: np.ndarray, resolution: float = 0.05):
    """Map point cloud → 2D occupancy grid — the inverse utility,
    mirroring `pointcloud2occupancy.cpp:108-158`: the grid spans the
    cloud's XY bounding box truncated to cells with a one-cell margin
    (`findMinMaxXY` `:108-131`), every cell holding a point is 100,
    everything else 0 (`createOccupancy` `:134-158`).

    Returns (grid (H, W) int8 with rows in world-y order, origin (x, y)).
    A grid row y / col x covers world [origin + idx*res, +res).
    """
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if len(pts) == 0:
        return np.zeros((0, 0), np.int8), (0.0, 0.0)
    # int() truncation (toward zero) then ±1 — exactly the reference.
    min_x_i = int(pts[:, 0].min() / resolution) - 1
    min_y_i = int(pts[:, 1].min() / resolution) - 1
    max_x_i = int(pts[:, 0].max() / resolution) + 1
    max_y_i = int(pts[:, 1].max() / resolution) + 1
    w = max_x_i - min_x_i
    h = max_y_i - min_y_i
    grid = np.zeros((h, w), np.int8)
    xi = (pts[:, 0] / resolution).astype(np.int64) - min_x_i
    yi = (pts[:, 1] / resolution).astype(np.int64) - min_y_i
    ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    grid[yi[ok], xi[ok]] = 100
    return grid, (min_x_i * resolution, min_y_i * resolution)
