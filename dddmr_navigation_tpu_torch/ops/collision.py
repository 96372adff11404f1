"""Swept oriented-box collision test over a fleet's rollouts.

Counterpart of ``dddmr_navigation_tpu/ops/collision.py``. A rollout step's
footprint box is given by its three unit axes ``axes`` (rows: box x/y/z in
the world frame), the center projections ``projc[k] = axes[k]·center`` and
the half extents ``half``. A point p is inside iff
``|axes[k]·p − projc[k]| ≤ half[k]`` for every k.

``swept_box_hits`` dispatches on the tensors' device: CPU tensors go to
:func:`swept_box_hits_plain`, CUDA tensors to the hand-written kernel in
``csrc/swept_box_hits.cu``; anything else raises.
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


swept_box_hits.launches = 0
