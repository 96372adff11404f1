"""Line-of-sight gating of long graph edges against each robot's lethal
cloud.

Counterpart of ``dddmr_navigation_tpu/planning/global_/los.py``
(`A_Star_on_Graph::isLineOfSightClear`, `a_star_on_pc.cpp:168-198`): every
edge ≥ 2×inscribed is sampled, lethal points within 2×inscribed of each
sample are counted, and more than one at any sample blocks the edge.
"""
from __future__ import annotations

import numpy as np
import torch

from dddmr_navigation_tpu_torch.rounding import fma_dot
from dddmr_navigation_tpu_torch.ops.compaction import first_k_true_indices


def long_edge_los_mask(nbr_idx, nbr_dist, nbr_valid, positions,
                       lethal_pts, lethal_valid, *,
                       inscribed_radius: float,
                       max_long_edges: int = 4096,
                       samples: int = 32):
    """(B, G, K) bool: False where a long edge is blocked.

    Args:
      nbr_idx, nbr_dist: (G, K) shared table; nbr_valid: (G, K) or
        (B, G, K).
      positions: (G, 3).
      lethal_pts: (B, L, 3) padded lethal clouds; lethal_valid: (B, L).
    """
    g, k = nbr_idx.shape
    b = lethal_pts.shape[0]
    long_edge = (nbr_valid & (nbr_dist >= 2.0 * inscribed_radius)).expand(
        b, g, k)
    e_idx = first_k_true_indices(long_edge.reshape(b, -1), max_long_edges)
    e_ok = e_idx >= 0
    safe_e = torch.clamp(e_idx, min=0)
    src = safe_e // k
    dst = torch.clamp(nbr_idx.reshape(-1)[safe_e], min=0).long()

    p0 = positions[src]                                          # (B, E, 3)
    p1 = positions[dst]
    t = torch.as_tensor(np.linspace(0.0, 1.0, samples, dtype=np.float32),
                        device=positions.device)
    pts = p0[:, :, None, :] + t[:, None] * (p1 - p0)[:, :, None, :]

    # (E·S, L) squared distances in the expansion form, the cross term a
    # matmul (TF32 off).
    a = pts.reshape(b, -1, 3)
    a2 = fma_dot(a, a)
    b2 = fma_dot(lethal_pts, lethal_pts)
    cross = torch.matmul(a, lethal_pts.transpose(1, 2))
    d2 = a2[:, :, None] + b2[:, None, :] - 2.0 * cross
    hit = (d2 <= (2.0 * inscribed_radius) ** 2) & lethal_valid[:, None, :]
    counts = hit.sum(dim=-1).view(b, -1, samples)                # (B, E, S)
    blocked = (counts > 1).any(dim=-1) & e_ok

    mask = torch.ones((b, g * k + 1), dtype=torch.bool,
                      device=positions.device)
    mask.scatter_(1, torch.where(e_ok, safe_e, g * k), ~blocked)
    return mask[:, :g * k].view(b, g, k)


def long_edge_counts(nbr_dist, nbr_valid, *, inscribed_radius: float,
                     max_long_edges: int):
    """(long edges, those :func:`long_edge_los_mask` checks) of each
    robot's graph, (B,) device tensors: edges past ``max_long_edges`` go
    ungated. nbr_valid (G, K) or (B, G, K)."""
    long_edge = nbr_valid & (nbr_dist >= 2.0 * inscribed_radius)
    seen = long_edge.reshape(-1, long_edge.shape[-2] * long_edge.shape[-1]
                             ).sum(dim=1)
    return seen, torch.clamp(seen, max=max_long_edges)


def lethal_cloud_from_dgraph(ground, ground_valid, dgraph, *,
                             inscribed_radius: float, max_lethal: int = 2048):
    """Each robot's lethal cloud: ground nodes whose distance field is
    lethal (`multilayer_spinning_lidar.cpp:283-306`). ground (G, 3),
    ground_valid (G,) or (B, G), dgraph (B, G). Returns ((B, L, 3),
    (B, L))."""
    lethal = ground_valid & (dgraph <= inscribed_radius)
    idx = first_k_true_indices(lethal, max_lethal)
    ok = idx >= 0
    pts = ground[torch.clamp(idx, min=0)]
    return torch.where(ok[..., None], pts, 1e6), ok
