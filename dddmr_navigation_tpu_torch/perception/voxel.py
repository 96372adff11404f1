"""Voxel indexing of the perception window, batched over robots.

Counterpart of ``dddmr_navigation_tpu/perception/voxel.py``: truncating
voxel keys ``int(c/res)`` (the reference's, not floor) and a dense,
world-anchored, robot-following ``(Nx, Ny, Nz)`` window per robot.

Rounding: inside the JAX package's jitted tick, XLA on the CPU compiles a
division by a constant as a multiply by the constant's f32 reciprocal; the
port divides the same way (``rounding.recip``), so voxel keys agree at cell
boundaries.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dddmr_navigation_tpu_torch.rounding import recip


class VoxelSpec(NamedTuple):
    """Static geometry of the perception window."""
    nx: int
    ny: int
    nz: int
    xy_resolution: float
    height_resolution: float


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype, device):
    """The constant tensor ``values`` on ``device``, copied there once: a
    copy per call would be a host sync, which a captured CUDA graph
    refuses. Shared by every caller: never write into it."""
    return torch.tensor(values, dtype=dtype, device=device)


def world_to_cell(spec: VoxelSpec, pts):
    """Global voxel coords, int(c/res) truncating toward zero: (..., 3)
    int32."""
    rx, rz = recip(spec.xy_resolution), recip(spec.height_resolution)
    return torch.stack([torch.trunc(pts[..., 0] * rx),
                        torch.trunc(pts[..., 1] * rx),
                        torch.trunc(pts[..., 2] * rz)], dim=-1).int()


def cell_to_world(spec: VoxelSpec, cells):
    """Voxel corner position, ``idx*res`` (the reference's representative
    point)."""
    res = device_constant((spec.xy_resolution, spec.xy_resolution,
                           spec.height_resolution), torch.float32,
                          cells.device)
    return cells.float() * res


def window_origin_for(spec: VoxelSpec, robot_xyz):
    """Window origin cell that centers the window on each robot: (B, 3)."""
    half = device_constant((spec.nx // 2, spec.ny // 2, spec.nz // 2),
                           torch.int32, robot_xyz.device)
    return world_to_cell(spec, robot_xyz) - half


def in_window(spec: VoxelSpec, local_cells):
    return ((local_cells[..., 0] >= 0) & (local_cells[..., 0] < spec.nx)
            & (local_cells[..., 1] >= 0) & (local_cells[..., 1] < spec.ny)
            & (local_cells[..., 2] >= 0) & (local_cells[..., 2] < spec.nz))


def scroll_grid(grid, origin, new_origin):
    """Re-anchor each robot's window grid (B, Nx, Ny, Nz) at ``new_origin``
    (B, 3), zero-filling cells that scroll into view.

    The JAX version rolls by a traced shift; here each axis is one gather
    at ``i + shift``, masked where that leaves the window, so no shift is
    read back to the host.
    """
    shift = (new_origin - origin).long()
    b = grid.shape[0]
    g = grid
    for axis in range(3):
        n = g.shape[axis + 1]
        src = torch.arange(n, device=g.device) + shift[:, axis, None]  # (B, n)
        keep = (src >= 0) & (src < n)
        shape = [b, 1, 1, 1]
        shape[axis + 1] = n
        moved = torch.gather(g, axis + 1,
                             src.clamp(0, n - 1).view(shape).expand_as(g))
        g = torch.where(keep.view(shape), moved, 0).to(grid.dtype)
    return g
