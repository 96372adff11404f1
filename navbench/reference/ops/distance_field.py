"""Masked nearest-point distance over a fleet: the plain version alone (a
frozen copy of the port's ``ops/distance_field.py``).
"""
from __future__ import annotations

import torch


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


# The reference has no kernel: every device takes the plain version.
masked_min_distance = masked_min_distance_plain
