"""Static map context: the ground cloud and map cloud as lookup tables.

Counterpart of ``dddmr_navigation_tpu/perception/static_map.py``: a dense
2D ground heightmap (the reference's 0.05 m ground-attach radius search,
`multilayer_spinning_lidar.cpp:370-373`), a dense 3D static occupancy grid
(its 0.1 m map search, `:383-393`) and the ground-node arrays. Built once
on the host with numpy; one map serves every robot.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from navbench.reference.rounding import recip


@dataclass(frozen=True)
class MapContext:
    """Per-map tensors, shared by all robots."""
    ground: torch.Tensor          # (G, 3) f32 ground node positions
    ground_valid: torch.Tensor    # (G,) bool
    node_weight: torch.Tensor     # (G,) f32
    height: torch.Tensor          # (Hx, Hy) f32 ground z (inf where none)
    height_origin: torch.Tensor   # (2,) f32 world xy of cell (0, 0)
    static_occ: torch.Tensor      # (Sx, Sy, Sz) uint8
    static_origin: torch.Tensor   # (3,) f32 world xyz of cell (0, 0, 0)
    height_res: float = 0.25
    static_res: float = 0.1


def build_map_context(ground_pts: np.ndarray, map_pts: np.ndarray | None = None,
                      *, height_res: float = 0.25, static_res: float = 0.1,
                      pad_to: int | None = None,
                      node_weight: np.ndarray | None = None,
                      device="cuda") -> MapContext:
    """The same tables as the JAX package's ``build_map_context``."""
    ground_pts = np.asarray(ground_pts, dtype=np.float32)[:, :3]
    if map_pts is None or len(map_pts) == 0:
        map_pts = np.zeros((1, 3), np.float32) + 1e6  # far away
    map_pts = np.asarray(map_pts, dtype=np.float32)[:, :3]

    g = len(ground_pts)
    pad = pad_to or g
    if pad < g:
        raise ValueError(f"pad_to {pad} < {g} ground points")
    ground = np.full((pad, 3), 1e6, np.float32)
    ground[:g] = ground_pts
    valid = np.zeros((pad,), bool)
    valid[:g] = True
    nw = np.zeros((pad,), np.float32)
    if node_weight is not None:
        nw[:g] = node_weight[:g]

    # Heightmap over ground bounds (+1 cell border).
    mn = ground_pts.min(0) - height_res
    mx = ground_pts.max(0) + height_res
    hx = int(np.ceil((mx[0] - mn[0]) / height_res)) + 1
    hy = int(np.ceil((mx[1] - mn[1]) / height_res)) + 1
    height = np.full((hx, hy), np.inf, np.float32)
    ix = ((ground_pts[:, 0] - mn[0]) / height_res).astype(np.int64)
    iy = ((ground_pts[:, 1] - mn[1]) / height_res).astype(np.int64)
    np.minimum.at(height, (ix, iy), ground_pts[:, 2])

    # Static occupancy over map bounds, the grid capped for far sentinels.
    smn = map_pts.min(0) - static_res
    smx = map_pts.max(0) + static_res
    dims = np.minimum(
        np.ceil((smx - smn) / static_res).astype(np.int64) + 1, 2048)
    occ = np.zeros(tuple(dims), np.uint8)
    ci = np.clip(((map_pts - smn) / static_res).astype(np.int64), 0, dims - 1)
    occ[ci[:, 0], ci[:, 1], ci[:, 2]] = 1

    def t(x):
        return torch.as_tensor(x, device=device)

    return MapContext(
        ground=t(ground), ground_valid=t(valid), node_weight=t(nw),
        height=t(height), height_origin=t(mn[:2].astype(np.float32)),
        static_occ=t(occ), static_origin=t(smn.astype(np.float32)),
        height_res=float(height_res), static_res=float(static_res))


def ground_height_at(ctx: MapContext, xy):
    """Ground z under world xy (..., 2): 3×3 neighborhood min, inf where
    unmapped."""
    ij = ((xy - ctx.height_origin) * recip(ctx.height_res)).long()
    hx, hy = ctx.height.shape
    out = torch.full(ij.shape[:-1], torch.inf, dtype=torch.float32,
                     device=xy.device)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            i = torch.clamp(ij[..., 0] + di, 0, hx - 1)
            j = torch.clamp(ij[..., 1] + dj, 0, hy - 1)
            out = torch.minimum(out, ctx.height[i, j])
    return out


def distance_to_ground(ctx: MapContext, pts):
    """|z - h(x, y)|; inf where no ground is mapped."""
    h = ground_height_at(ctx, pts[..., :2])
    return torch.where(torch.isfinite(h), torch.abs(pts[..., 2] - h),
                       torch.inf)


def near_static(ctx: MapContext, pts, radius: float):
    """True where static map occupancy lies within a cube of
    ceil(radius / static_res) cells around each point."""
    r_cells = max(int(np.ceil(radius / ctx.static_res)), 1)
    ci = ((pts - ctx.static_origin) * recip(ctx.static_res)).long()
    sx, sy, sz = ctx.static_occ.shape
    hit = torch.zeros(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    for dx in range(-r_cells, r_cells + 1):
        for dy in range(-r_cells, r_cells + 1):
            for dz in range(-r_cells, r_cells + 1):
                x = torch.clamp(ci[..., 0] + dx, 0, sx - 1)
                y = torch.clamp(ci[..., 1] + dy, 0, sy - 1)
                z = torch.clamp(ci[..., 2] + dz, 0, sz - 1)
                hit = hit | (ctx.static_occ[x, y, z] > 0)
    return hit
