"""Swept oriented-box collision test over a fleet's rollouts.

Counterpart of ``dddmr_navigation_tpu/ops/collision.py``. A rollout step's
footprint box is given by its three unit axes ``axes`` (rows: box x/y/z in
the world frame), the center projections ``projc[k] = axes[k]·center`` and
the half extents ``half``. A point p is inside iff
``|axes[k]·p − projc[k]| ≤ half[k]`` for every k.

``swept_box_hits`` dispatches on the tensors' device: CPU tensors go to
:func:`swept_box_hits_plain`, CUDA tensors to the hand-written kernel in
``csrc/swept_box_hits.cu``; anything else raises. On the card the kernel
first culls, per warp tile of ``TILE_SAMPLES`` × ``TILE_STEPS`` rows, the
obstacles outside a sphere that holds every box of the tile, and runs the
exact test on the rest; :func:`swept_box_cull_plain` mirrors that cull in
plain PyTorch, for the tests.
"""
from __future__ import annotations

import torch

from dddmr_navigation_tpu_torch.ops._launch import (
    check_cuda_inputs, launch, raise_unless_cpu)


# Obstacles per pass of the plain version: bounds its (B,S,N,C) temporaries.
_PLAIN_CHUNK = 32


def swept_box_hits_plain(axes, projc, step_valid, obstacles, obs_valid, half):
    """Plain PyTorch version: elementwise projections over chunks of
    obstacles, in the kernel's operation order. Same arguments as
    :func:`swept_box_hits`."""
    b, s, n = step_valid.shape
    k_total = obstacles.shape[1]
    hit = torch.zeros((b, s), dtype=torch.bool, device=step_valid.device)
    for c0 in range(0, k_total, _PLAIN_CHUNK):
        pts = obstacles[:, None, None, c0:c0 + _PLAIN_CHUNK]  # (B,1,1,C,3)
        px, py, pz = pts[..., 0], pts[..., 1], pts[..., 2]
        inside = None
        for k in range(3):
            proj = (axes[..., k, 0, None] * px + axes[..., k, 1, None] * py
                    + axes[..., k, 2, None] * pz)                # (B,S,N,C)
            ok = torch.abs(proj - projc[..., k, None]) <= half[k]
            inside = ok if inside is None else inside & ok
        inside = (inside & obs_valid[:, None, None, c0:c0 + _PLAIN_CHUNK]
                  & step_valid[..., None])
        hit |= inside.any(dim=3).any(dim=2)
    return hit


def swept_box_hits(axes, projc, step_valid, obstacles, obs_valid, half):
    """True per (robot, sample) when any valid obstacle is inside the
    oriented footprint box at any valid rollout step.

    Args:
      axes: (B, S, N, 3, 3) f32 unit box axes (rows) per robot/sample/step.
      projc: (B, S, N, 3) f32 axes·center projections.
      step_valid: (B, S, N) bool valid-step mask.
      obstacles: (B, K, 3) f32 points, in the same frame as the boxes.
      obs_valid: (B, K) bool.
      half: three floats, the box half extents (f32 values).

    Returns: (B, S) bool.
    """
    if axes.device.type != "cuda":
        raise_unless_cpu(axes)
        return swept_box_hits_plain(axes, projc, step_valid, obstacles,
                                    obs_valid, half)
    return _launch_hits(axes, projc, step_valid, obstacles, obs_valid, half)


swept_box_hits.launches = 0


def _launch_hits(axes, projc, step_valid, obstacles, obs_valid, half):
    b, s, n = step_valid.shape
    k = obstacles.shape[1]
    check_cuda_inputs(
        (axes, (b, s, n, 3, 3), torch.float32),
        (projc, (b, s, n, 3), torch.float32),
        (step_valid, (b, s, n), torch.bool),
        (obstacles, (b, k, 3), torch.float32),
        (obs_valid, (b, k), torch.bool))
    hits = torch.zeros((b, s), dtype=torch.uint8, device=axes.device)
    h0, h1, h2 = (float(x) for x in half)
    launch("swept_box_hits_launch", axes, projc, step_valid.view(torch.uint8),
           obstacles, obs_valid.view(torch.uint8), b, s, n, k, h0, h1, h2,
           hits)
    swept_box_hits.launches += 1
    return hits.view(torch.bool)


# The kernel's warp tile and cull margins (csrc/swept_box_hits.cu).
TILE_SAMPLES, TILE_STEPS = 8, 4
_MARGIN_ABS, _MARGIN_REL, _MAX_ETA = 1.0e-3, 1.0e-5, 0.5


def _tiles(x, fill):
    """(B, S, N, ...) → (B, W, 32, ...): the rows of each warp tile, W tiles
    of TILE_SAMPLES samples × TILE_STEPS steps, samples-major, as the kernel
    numbers them; padding rows take ``fill``."""
    b, s, n = x.shape[:3]
    gs, gn = -(-s // TILE_SAMPLES), -(-n // TILE_STEPS)
    pad = [0, 0] * (x.dim() - 3) + [0, gn * TILE_STEPS - n,
                                    0, gs * TILE_SAMPLES - s]
    if x.dtype == torch.bool:
        x = torch.nn.functional.pad(x.to(torch.uint8), pad,
                                    value=int(fill)).bool()
    else:
        x = torch.nn.functional.pad(x, pad, value=fill)
    x = x.reshape(b, gs, TILE_SAMPLES, gn, TILE_STEPS, *x.shape[3:])
    return x.transpose(2, 3).reshape(b, gs * gn, TILE_SAMPLES * TILE_STEPS,
                                     *x.shape[5:])


def swept_box_cull_plain(axes, projc, step_valid, obstacles, obs_valid, half):
    """The kernel's cull in plain PyTorch (f32, FMA chains as separate
    operations; the margins cover the difference). Same arguments as
    :func:`swept_box_hits`.

    Returns (keep (B, W, K) bool: obstacle k survives tile w's sphere test;
    rows (B, W, 32) bool: the tile's valid rows)."""
    x0 = torch.einsum("bsnkj,bsnk->bsnj", axes, projc)           # A^T c
    g = torch.einsum("bsnij,bsnkj->bsnik", axes, axes) - torch.eye(
        3, dtype=axes.dtype, device=axes.device)
    eta = torch.sqrt((g * g).sum(dim=(-1, -2)))
    hn = float(torch.linalg.vector_norm(torch.tensor(half,
                                                     dtype=torch.float32)))
    xn = torch.linalg.vector_norm(x0, dim=-1)
    radius = ((eta * xn + torch.sqrt(1.0 + eta) * hn) / (1.0 - eta)
              + _MARGIN_ABS + _MARGIN_REL * (xn + hn))
    radius = torch.where(eta < _MAX_ETA, radius, torch.inf)
    rows = _tiles(step_valid, False)                             # (B,W,32)
    xt = _tiles(x0, 0.0)                                         # (B,W,32,3)
    # fminf/fmaxf: a NaN center stays out of the box
    lo = torch.where(rows[..., None] & ~xt.isnan(), xt, torch.inf).amin(2)
    hi = torch.where(rows[..., None] & ~xt.isnan(), xt, -torch.inf).amax(2)
    center = 0.5 * (lo + hi)                                     # (B,W,3)
    reach = (torch.linalg.vector_norm(xt - center[:, :, None], dim=-1)
             + _tiles(radius, 0.0))
    reach = torch.where(reach <= 3.0e38, reach, torch.inf)       # NaN → inf
    wr = torch.where(rows, reach, -torch.inf).amax(2) * (1.0 + 1.0e-5)
    pts = torch.where(obs_valid[..., None], obstacles, 1.0e9)    # (B,K,3)
    d = pts[:, None, :, :] - center[:, :, None, :]               # (B,W,K,3)
    d2 = (d * d).sum(-1)
    keep = ~(d2 > (wr * wr)[..., None]) & rows.any(2, keepdim=True)
    return keep, rows

