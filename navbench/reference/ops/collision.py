"""Swept oriented-box collision test over a fleet's rollouts: the plain
version alone (a frozen copy of the port's ``ops/collision.py``).
"""
from __future__ import annotations

import torch

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


# The reference has no kernel: every device takes the plain version.
swept_box_hits = swept_box_hits_plain
