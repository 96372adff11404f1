"""Range-image projection, ground removal and segmentation, the
counterpart of ``dddmr_navigation_tpu/slam/projection.py`` (lego_loam's
``ImageProjection``, `lego_loam_bor/src/imageProjection.cpp:309-660`).

The scan lives as dense (V, H) tensors end to end: projection is a scatter
by (ring, column), ground removal a vectorized inter-ring angle test, and
segmentation connected-component labeling by a fixed number of min-label
sweeps over the angle-gated 4-neighbourhood (columns wrap).

The port equals the JAX package's jitted frontend bit for bit on the CPU,
and on the card, since every integer that follows a float here (the image
cell, the ground flag, the segmentation gate) changes every feature
downstream:

* the cell's row and column round as XLA does on the CPU: ``atan2`` is
  glibc's (``rounding.atan2_xla``), ``‖(x, y)‖`` and ``‖(x, y, z)‖`` fuse
  ``x·x + y·y`` into ``fma(x, x, y·y)`` and the ``+ z·z`` into a second
  FMA, a division by a constant is a multiply by its f32 reciprocal and
  ``(azim + π) / 2π · H`` multiplies by one folded constant
  (``rounding.recip_times``): simulated scans put every point on a column
  boundary, so an ulp moves it to the next column;
* a cell that two points fall into takes the last one (XLA on the CPU
  applies ``.at[].set`` in order); the winner is the largest point index
  of the cell (``scatter_reduce`` ``amax``), and the values are gathered
  from it: ``index_put_`` with duplicate indices is nondeterministic on
  the card;
* the segmentation gate's ``d1 − d2·cos α`` is one FMA, as XLA contracts
  it.

The JAX session also projects each keyframe's scan eagerly, op by op, for
its patched ground; ``eager=True`` rounds as that call does (no fused
products, true divisions). :func:`patched_ground_points` is host numpy,
copied as it is.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dddmr_navigation_tpu_torch.config import SlamConfig
from dddmr_navigation_tpu_torch.rounding import (
    atan2_xla, f32, fma, fma_norm, recip, recip_times, sqrt_rn)

_DEGREES = f32(180.0 / np.pi)     # jnp.degrees multiplies by it
SEGMENT_SWEEPS = 48


class RangeImage(NamedTuple):
    rng: torch.Tensor      # (V, H) f32 range; 0 where empty
    pts: torch.Tensor      # (V, H, 3) f32 sensor-frame points
    valid: torch.Tensor    # (V, H) bool
    ground: torch.Tensor   # (V, H) bool ground-flagged pixels
    labels: torch.Tensor   # (V, H) i32 segment label, -1 invalid/outlier
    segment_mask: torch.Tensor  # (V, H) bool pixels in valid segments


def project_scan(cfg: SlamConfig, points, mask, eager: bool = False):
    """Scatter a raw scan (``points`` (N, 3) f32, ``mask`` (N,) bool) into
    the (V, H) range image (`imageProjection.cpp:317-408`): row from
    elevation against the vertical FOV, column from azimuth; the last
    point into a cell wins. Returns (rng, pts, valid).

    ``eager``: round as the JAX package's eager (op-by-op) call of
    ``project`` does, where nothing fuses and a division by a constant
    divides truly (the keyframe's patched-ground image); otherwise as its
    jitted frontend."""
    v, h = cfg.num_vertical_scans, cfg.num_horizontal_scans
    pts = points.to(torch.float32)
    x, y, z = pts.unbind(-1)
    xy2 = x * x + y * y if eager else fma(x, x, y * y)
    rng = sqrt_rn(xy2 + z * z if eager else fma(z, z, xy2))
    elev = atan2_xla(z, sqrt_rn(xy2)) * _DEGREES
    ang_res_y = (cfg.vertical_angle_top - cfg.vertical_angle_bottom) / (v - 1)
    elev = elev - f32(cfg.vertical_angle_bottom)
    row = elev / _const(ang_res_y, pts) if eager else elev * recip(ang_res_y)
    row = torch.round(row).to(torch.int64)
    azim = atan2_xla(y, x) + f32(np.pi)
    if eager:
        col = azim / _const(2.0 * np.pi, pts) * f32(h)
    else:
        col = azim * recip_times(2.0 * np.pi, h)
    col = torch.clamp(torch.floor(col).to(torch.int64), 0, h - 1)

    ok = (mask.to(torch.bool) & (row >= 0) & (row < v)
          & (rng > f32(0.1)) & (rng <= f32(cfg.maximum_detection_range)))
    n = pts.shape[0]
    cell = torch.where(ok, row * h + col, v * h)     # v·h collects the rest
    order = torch.arange(n, dtype=torch.int64, device=pts.device)
    winner = torch.full((v * h + 1,), -1, dtype=torch.int64,
                        device=pts.device).scatter_reduce(
        0, cell, torch.where(ok, order, -1), "amax")[:v * h]
    valid = winner >= 0
    src = torch.clamp(winner, min=0)
    img_rng = torch.where(valid, rng[src], 0.0).reshape(v, h)
    img_pts = torch.where(valid[:, None], pts[src], 0.0).reshape(v, h, 3)
    return img_rng, img_pts, valid.reshape(v, h)


def _const(c: float, like):
    """The f32 constant ``c`` as a tensor on ``like``'s device: dividing
    by it divides truly on the card too, where a Python divisor becomes a
    multiply by its reciprocal."""
    return torch.full((), f32(c), dtype=torch.float32, device=like.device)


def mark_ground(cfg: SlamConfig, img_pts, valid):
    """Ground removal (`imageProjection.cpp:408-445`): below
    ``ground_scan_index``, a pixel pair (r, r+1) whose inter-ring angle
    ``atan2(dz, ‖d‖)`` plus the mount angle lies within the threshold
    flags both pixels as ground."""
    v, h = valid.shape
    d = img_pts[1:] - img_pts[:-1]
    ang = atan2_xla(d[..., 2], fma_norm(d)) * _DEGREES
    ang = ang + f32(cfg.sensor_mount_angle)
    pair_ok = valid[:-1] & valid[1:]
    thr = f32(cfg.ground_angle_threshold)
    gp = pair_ok & (ang <= thr) & (ang >= -thr)
    rows = torch.arange(v - 1, device=valid.device)[:, None]
    gp = gp & (rows < cfg.ground_scan_index)
    ground = torch.zeros((v, h), dtype=torch.bool, device=valid.device)
    ground[:-1] = gp
    ground[1:] |= gp
    return ground & valid


def _angle_criterion(cfg: SlamConfig, rng_a, rng_b, alpha: float,
                     eager: bool = False):
    """LOAM's segmentation angle (`labelComponents`): for adjacent beams
    with ranges d1 ≥ d2 at beam angle alpha, beta = atan2(d2·sin α,
    d1 − d2·cos α) > segment_theta."""
    d1 = torch.maximum(rng_a, rng_b)
    d2 = torch.minimum(rng_a, rng_b)
    ca = f32(np.cos(alpha))
    beta = atan2_xla(d2 * f32(np.sin(alpha)),
                     d1 - d2 * ca if eager else fma(-d2, ca, d1))
    return beta > f32(np.radians(cfg.segment_theta))


def segment_image(cfg: SlamConfig, img_rng, valid, ground,
                  num_iters: int = SEGMENT_SWEEPS, eager: bool = False):
    """Connected components on non-ground pixels with angle-gated
    4-connectivity (columns wrap). Returns (labels (V, H) i32, −1 for
    invalid, ground or rejected pixels; segment_mask (V, H) bool).

    Each sweep takes every pixel's minimum label over itself and its gated
    neighbours: the neighbour table (a pixel's own index where the gate is
    closed) is built once, so a sweep is one gather and one min, where the
    JAX package rolls the label image four times; both give the same
    labels, sweep by sweep. A segment is accepted with ≥
    ``segment_valid_point_num`` pixels, or ≥ 3 pixels on ≥
    ``segment_valid_line_num`` rings (`imageProjection.cpp:536-594`)."""
    v, h = valid.shape
    dev = valid.device
    seg = valid & ~ground
    ang_res_x = 2.0 * np.pi / cfg.num_horizontal_scans
    ang_res_y = np.radians((cfg.vertical_angle_top - cfg.vertical_angle_bottom)
                           / (cfg.num_vertical_scans - 1))
    right_ok = seg & torch.roll(seg, -1, 1) & _angle_criterion(
        cfg, img_rng, torch.roll(img_rng, -1, 1), ang_res_x, eager)
    up_ok = seg & torch.roll(seg, -1, 0) & _angle_criterion(
        cfg, img_rng, torch.roll(img_rng, -1, 0), ang_res_y, eager)
    up_ok[-1] = False                      # no vertical wrap
    left_ok = torch.roll(right_ok, 1, 1)
    down_ok = torch.roll(up_ok, 1, 0)      # row 0 gets up_ok[-1] = False

    lin = torch.arange(v * h, dtype=torch.int64, device=dev).reshape(v, h)
    nbr = torch.stack([
        lin,
        torch.where(right_ok, torch.roll(lin, -1, 1), lin),
        torch.where(left_ok, torch.roll(lin, 1, 1), lin),
        torch.where(up_ok, torch.roll(lin, -1, 0), lin),
        torch.where(down_ok, torch.roll(lin, 1, 0), lin)]).reshape(5, -1)
    big = v * h + 1
    labels = torch.where(seg, lin, big).reshape(-1).to(torch.int32)
    for _ in range(num_iters):
        labels = labels[nbr].amin(dim=0)

    seg_f = seg.reshape(-1)
    lbl = labels.to(torch.int64)
    counts = torch.zeros((v * h + 2,), dtype=torch.int32, device=dev)
    counts.index_add_(0, lbl, torch.ones_like(labels))
    ring = torch.arange(v, dtype=torch.int64, device=dev).repeat_interleave(h)
    pair = torch.where(seg_f, lbl * v + ring, (v * h + 1) * v)
    ring_hit = torch.zeros(((v * h + 2) * v,), dtype=torch.int32,
                           device=dev).index_fill_(0, pair, 1)
    rings_per_label = ring_hit.reshape(v * h + 2, v).sum(dim=1)
    c = counts[lbl]
    accepted = seg_f & ((c >= cfg.segment_valid_point_num)
                        | ((c >= 3) & (rings_per_label[lbl]
                                       >= cfg.segment_valid_line_num)))
    labels = torch.where(accepted, labels, -1).reshape(v, h)
    return labels, accepted.reshape(v, h)


def project(cfg: SlamConfig, points, mask, eager: bool = False
            ) -> RangeImage:
    """Full projection pipeline: scatter → ground → segments; ``eager`` as
    in :func:`project_scan`."""
    img_rng, img_pts, valid = project_scan(cfg, points, mask, eager)
    ground = mark_ground(cfg, img_pts, valid)
    labels, seg_mask = segment_image(cfg, img_rng, valid, ground,
                                     eager=eager)
    return RangeImage(rng=img_rng, pts=img_pts, valid=valid, ground=ground,
                      labels=labels, segment_mask=seg_mask)


def patched_ground_points(cfg: SlamConfig, img_pts, valid, ground,
                          first_frame: bool = False):
    """The reference's patched-ground construction
    (`imageProjection.cpp:408-516`, the cloud `pcdSaver` stitches into the
    saved ``ground.pcd`` / per-keyframe ``*_ground.pcd`` via
    ``patchedGroundKeyFrames``, `mapOptimization.cpp:211-217,285`):

      * per azimuth column, every ground ring-pair (i, i+1) below
        ``ground_scan_index`` whose inter-ring gap is under
        ``distance_for_patch_between_rings`` emits interpolated points at
        the C++ loop's exact parametrization ``t = 0, dt, …`` with
        ``dt = 1/(ds/0.1 + 1)`` plus the upper endpoint;
      * the outermost patched ring per column contributes a ground-EDGE
        point (intensity 100 — `patched_ground_edge_`, the cloud the
        ground-edge detection thread refines, `mapOptimization.h:119`);
      * on the first frames (``first_frame``) the blind circle under the
        robot is filled from the closest ring edge toward base_link at the
        ring's own height (`imageProjection.cpp:482-506`);
      * both clouds voxel-downsample at the reference's 0.1 m leaf.

    Host-side (artifact/keyframe rate, not the control path): the
    arguments are numpy arrays (or tensors, read to the host). Returns
    (ground_pts (P, 3), edge_pts (E, 3)) float32 numpy arrays.
    """
    from dddmr_navigation_tpu_torch.io.maps import voxel_downsample

    img_pts, valid, ground = (
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in (img_pts, valid, ground))
    v, h = valid.shape
    gsi = int(cfg.ground_scan_index)
    out, edges = [], []
    for j in range(h):
        ring_edge = 0
        closest_ring_edge = gsi
        do_patch = False
        for i in range(gsi):
            if not (valid[i, j] and valid[i + 1, j]
                    and ground[i, j] and ground[i + 1, j]):
                continue
            lo = img_pts[i, j]
            dvec = img_pts[i + 1, j] - lo
            ds = float(np.linalg.norm(dvec))
            if i < closest_ring_edge:
                closest_ring_edge = i
            if ds < cfg.distance_for_patch_between_rings:
                ring_edge = i + 1
                dt = 1.0 / (ds / 0.1 + 1.0)
                t = 0.0
                while t <= 1.0:
                    out.append(lo + dvec * t)
                    t += dt
                out.append(lo + dvec)
                do_patch = True
        if valid[ring_edge, j]:
            edges.append(img_pts[ring_edge, j])
        if do_patch and first_frame and closest_ring_edge < gsi \
                and valid[closest_ring_edge, j]:
            p0 = img_pts[closest_ring_edge, j]
            for t in np.arange(0.0, 1.0 + 1e-6, 0.05):
                out.append([p0[0] * (1 - t), p0[1] * (1 - t), p0[2]])
    gpts = (np.asarray(out, np.float32) if out
            else np.zeros((0, 3), np.float32))
    epts = (np.asarray(edges, np.float32) if edges
            else np.zeros((0, 3), np.float32))
    return (voxel_downsample(gpts, 0.1).astype(np.float32),
            voxel_downsample(epts, 0.1).astype(np.float32))
