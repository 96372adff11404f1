"""Masked nearest-point distance over a fleet.

Counterpart of ``dddmr_navigation_tpu/ops/distance_field.py``: for each
query point, the Euclidean distance to the nearest valid point of a padded
point set, from direct differences (dx²+dy²+dz²; never the |a|²+|b|²−2ab
form, whose cancellation `critics.py:35-43` of the JAX package explains).

``masked_min_distance`` dispatches on the tensors' device: CPU tensors go
to :func:`masked_min_distance_plain`, CUDA tensors to the hand-written
kernel in ``csrc/masked_min_distance.cu``; anything else raises. On the
card the kernel computes only the valid points (and the parking point
once); :func:`masked_min_distance_compacted_plain` mirrors that point set
in plain PyTorch, for the tests.
"""
from __future__ import annotations

import torch

from dddmr_navigation_tpu_torch.ops._launch import (
    check_cuda_inputs, launch, raise_unless_cpu)

_BIG = 1.0e12         # initial squared distance
_FAR = 1.0e6          # coordinate of invalid points, result of masked queries
# (query, point) pairs per pass of the plain version: bounds its temporaries.
_PLAIN_PAIRS = 1 << 22


def masked_min_distance_plain(queries, q_mask, points, p_mask):
    """Plain PyTorch version, in the kernel's operation order. Same
    arguments as :func:`masked_min_distance`."""
    b, q, _ = queries.shape
    m = points.shape[1]
    pts = torch.where(p_mask[..., None], points, _FAR)
    best = torch.full((b, q), _BIG, dtype=torch.float32,
                      device=queries.device)
    chunk = max(1, _PLAIN_PAIRS // max(1, b * q))
    for c0 in range(0, m, chunk):
        d = queries[:, :, None, :] - pts[:, None, c0:c0 + chunk, :]
        dx, dy, dz = d.unbind(-1)
        d2 = dx * dx + dy * dy + dz * dz                       # (B,Q,C)
        best = torch.minimum(best, d2.amin(dim=-1))
    # PyTorch's vectorised f32 sqrt on the CPU may miss the correctly
    # rounded result by an ulp; the f64 root rounded to f32 is exact, as
    # the kernel's sqrtf is.
    return torch.where(q_mask, torch.sqrt(best.double()).float(), _FAR)


def masked_min_distance(queries, q_mask, points, p_mask):
    """Distance from each query to the nearest valid point of its robot.

    Args:
      queries: (B, Q, 3) f32.
      q_mask: (B, Q) bool; masked queries return 1e6.
      points: (B, M, 3) f32 padded point sets.
      p_mask: (B, M) bool.

    Returns: (B, Q) f32 (1e6 where the query is masked or the robot's
    point set is empty).
    """
    if queries.device.type != "cuda":
        raise_unless_cpu(queries)
        return masked_min_distance_plain(queries, q_mask, points, p_mask)
    return _launch_dist(queries, q_mask, points, p_mask)


masked_min_distance.launches = 0


def _launch_dist(queries, q_mask, points, p_mask):
    b, q, _ = queries.shape
    m = points.shape[1]
    check_cuda_inputs(
        (queries, (b, q, 3), torch.float32),
        (q_mask, (b, q), torch.bool),
        (points, (b, m, 3), torch.float32),
        (p_mask, (b, m), torch.bool))
    out = torch.empty((b, q), dtype=torch.float32, device=queries.device)
    launch("masked_min_distance_launch", queries, q_mask.view(torch.uint8),
           points, p_mask.view(torch.uint8), b, q, m, out)
    masked_min_distance.launches += 1
    return out


def masked_min_distance_compacted_plain(queries, q_mask, points, p_mask):
    """The point set the kernel computes, in plain PyTorch: per robot, its
    valid points and, when any point is invalid, one copy of the parking
    point (1e6, 1e6, 1e6) where the plain version parks every invalid
    point. Same arguments as :func:`masked_min_distance`.

    Returns (staged (B,) int64: the points computed per robot; out (B, Q)
    f32: the distances from those alone, which must equal
    :func:`masked_min_distance_plain`'s)."""
    b, q, _ = queries.shape
    m = points.shape[1]
    n_valid = p_mask.sum(1)
    parked = n_valid < m
    # valid points first, in order, then the parking point
    order = torch.argsort((~p_mask).to(torch.int8), dim=1, stable=True)
    pts = points.gather(1, order[..., None].expand(-1, -1, 3))
    slot = torch.arange(m, device=points.device)
    park = (slot[None] == n_valid[:, None]) & parked[:, None]
    pts = torch.where(park[..., None], _FAR, pts)
    staged = n_valid + parked
    used = slot[None] < staged[:, None]                          # (B, M)
    best = torch.full((b, q), _BIG, dtype=torch.float32,
                      device=queries.device)
    chunk = max(1, _PLAIN_PAIRS // max(1, b * q))
    for c0 in range(0, m, chunk):
        d = queries[:, :, None, :] - pts[:, None, c0:c0 + chunk, :]
        dx, dy, dz = d.unbind(-1)
        d2 = dx * dx + dy * dy + dz * dz                       # (B,Q,C)
        d2 = torch.where(used[:, None, c0:c0 + chunk], d2, torch.inf)
        best = torch.minimum(best, d2.amin(dim=-1))
    out = torch.where(q_mask, torch.sqrt(best.double()).float(), _FAR)
    return staged, out
