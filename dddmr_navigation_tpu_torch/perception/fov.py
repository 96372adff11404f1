"""Sensor FOV tests and the range image, batched over robots.

Counterpart of ``dddmr_navigation_tpu/perception/fov.py``
(`isinLidarObservation`, `multilayer_spinning_lidar.cpp:682-746`; the
ray-cast clearing loop redone as a min-range image).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dddmr_navigation_tpu_torch.geometry import (
    quat_rotate_fma, quat_conjugate)
from dddmr_navigation_tpu_torch.rounding import (
    asin_xla, atan2_xla, fma, fma_dot, fma_norm, recip_times)
from dddmr_navigation_tpu_torch.perception.voxel import device_constant

# jnp.degrees multiplies by the f32 constant 180/pi.
_RAD2DEG = float(np.float32(180.0 / np.pi))


class RangeImageSpec(NamedTuple):
    rows: int            # elevation bins
    cols: int            # azimuth bins
    elev_min_deg: float  # = vertical_FOV_bottom
    elev_max_deg: float  # = vertical_FOV_top
    max_range: float = 100.0


def spherical_rad(sensor_pos, sensor_quat, pts):
    """(range, elevation, azimuth) in radians of global points (B, N, 3)
    w.r.t. each robot's sensor pose (B, 3), (B, 4)."""
    d = pts - sensor_pos[:, None, :]
    rng = fma_norm(d)
    z = device_constant((0.0, 0.0, 1.0), torch.float32, pts.device)
    normal = quat_rotate_fma(sensor_quat, z.expand_as(sensor_pos))     # (B, 3)
    p2plane = fma_dot(d, normal[:, None, :])
    safe_rng = torch.clamp(rng, min=1e-9)
    elev = asin_xla(torch.clamp(p2plane / safe_rng, -1.0, 1.0))
    d_s = quat_rotate_fma(quat_conjugate(sensor_quat)[:, None, :], d)
    return rng, elev, atan2_xla(d_s[..., 1], d_s[..., 0])


def sensor_frame_spherical(sensor_pos, sensor_quat, pts):
    """(range, elevation_deg, azimuth_deg) of global points (B, N, 3)
    w.r.t. each robot's sensor pose (B, 3), (B, 4)."""
    rng, elev, azim = spherical_rad(sensor_pos, sensor_quat, pts)
    return rng, elev * _RAD2DEG, azim * _RAD2DEG


def in_fov(elev_deg, azim_deg, *, vertical_FOV_bottom, vertical_FOV_top,
           scan_effective_positive_start, scan_effective_positive_end,
           scan_effective_negative_start, scan_effective_negative_end):
    """Vectorized `isinLidarObservation` FOV predicate."""
    vert_ok = (elev_deg >= vertical_FOV_bottom) & (elev_deg <= vertical_FOV_top)
    pos_ok = ((azim_deg >= 0) & (azim_deg >= scan_effective_positive_start)
              & (azim_deg <= scan_effective_positive_end))
    neg_ok = ((azim_deg < 0) & (azim_deg <= scan_effective_negative_start)
              & (azim_deg >= scan_effective_negative_end))
    return vert_ok & (pos_ok | neg_ok)


def bins(spec: RangeImageSpec, elev, azim):
    """Range-image (row, col) of each direction, from radians; float→int
    truncates. The JAX package's jitted program converts to degrees and
    adds the offset in one fused multiply-add, then multiplies by the
    folded bin constant."""
    er = fma(elev, _RAD2DEG, -spec.elev_min_deg) * recip_times(
        max(spec.elev_max_deg - spec.elev_min_deg, 1e-6), spec.rows)
    row = torch.clamp(er.int(), 0, spec.rows - 1)
    ac = fma(azim, _RAD2DEG, 180.0) * recip_times(360.0, spec.cols)
    col = torch.clamp(ac.int(), 0, spec.cols - 1)
    return row, col


def _bins_deg(spec: RangeImageSpec, elev_deg, azim_deg):
    """Range-image (row, col) of directions given in degrees, as the JAX
    package's jitted ``_bins`` rounds them: the offset, then one multiply
    by the folded bin constant; float→int truncates."""
    er = (elev_deg - spec.elev_min_deg) * recip_times(
        max(spec.elev_max_deg - spec.elev_min_deg, 1e-6), spec.rows)
    row = torch.clamp(er.int(), 0, spec.rows - 1)
    ac = (azim_deg + 180.0) * recip_times(360.0, spec.cols)
    col = torch.clamp(ac.int(), 0, spec.cols - 1)
    return row, col


def lookup_range(spec: RangeImageSpec, img, elev_deg, azim_deg):
    """Min of the 3x3 bin neighborhood (rows clamp, columns wrap) of one
    range image (rows, cols) at directions in degrees — the analogue of the
    reference's distance-proportional spot size (min(dist/20+0.01, 0.1) m)
    which widens the ray into a cone
    (`multilayer_spinning_lidar.cpp:556-575`)."""
    row, col = _bins_deg(spec, elev_deg, azim_deg)
    out = torch.full(row.shape, torch.inf, dtype=torch.float32,
                     device=img.device)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            r = torch.clamp(row + dr, 0, spec.rows - 1).long()
            c = torch.remainder(col + dc, spec.cols).long()
            out = torch.minimum(out, img[r, c])
    return out


def build_range_image(spec: RangeImageSpec, sensor_pos, sensor_quat,
                      scan_pts, scan_mask):
    """Min-range image (B, rows, cols) of each robot's scan; empty bins
    hold ``max_range``. A min is order-free, so the scatter is
    deterministic."""
    b = scan_pts.shape[0]
    rng, elev, azim = spherical_rad(sensor_pos, sensor_quat, scan_pts)
    row, col = bins(spec, elev, azim)
    rng = torch.where(scan_mask & torch.isfinite(rng), rng, spec.max_range)
    cells = spec.rows * spec.cols
    img = torch.full((b * cells,), spec.max_range, dtype=torch.float32,
                     device=scan_pts.device)
    flat = (torch.arange(b, device=row.device)[:, None] * cells
            + row.long() * spec.cols + col.long())
    img.scatter_reduce_(0, flat.reshape(-1), rng.reshape(-1), "amin")
    return img.view(b, spec.rows, spec.cols)
