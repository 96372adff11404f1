"""Ground point-cloud graph construction.

The port's own copy of ``build_ground_graph`` and ``pad_graph`` from
``dddmr_navigation_tpu/planning/global_/graph.py`` (numpy and SciPy only).

The reference discovers successors dynamically per A* expansion with a
PCL/nanoflann radius search (`a_star_on_pc.cpp:238-245`: 0.5 m radius,
kNN-8 fallback for orphans) or uses a precomputed `StaticGraph`
(`static_layer.cpp:286-421`). On TPU the graph is *always* precomputed at
map load into padded (G, K) neighbor tables — the planner then needs only
gathers, no trees.

Also computes per-node auxiliaries the A* cost uses:
  * ``avg_intensity``: mean intensity over the expansion neighborhood
    (`a_star_on_pc.cpp:247-253`),
  * per-node weights from the static layer (boundary/orphan detection —
    see layers.py).

Construction is host-side (SciPy cKDTree), one-time per map.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class GroundGraph(NamedTuple):
    """Padded kNN/radius graph over ground nodes (device arrays)."""
    nbr_idx: np.ndarray     # (G, K) int32, -1 padding
    nbr_dist: np.ndarray    # (G, K) f32
    nbr_valid: np.ndarray   # (G, K) bool
    avg_intensity: np.ndarray  # (G,) f32
    num_nodes: int


def build_ground_graph(ground_pts: np.ndarray,
                       radius: float = 0.5,
                       k_max: int = 16,
                       orphan_k: int = 8,
                       intensity: np.ndarray | None = None) -> GroundGraph:
    """Radius graph with kNN fallback for orphans (reference semantics).

    Args:
      ground_pts: (G, 3) float ground nodes.
      radius: `a_star_expanding_radius` (0.5).
      k_max: padded neighbor count; nearest-K kept when a radius search
        returns more.
      orphan_k: kNN fallback size when a radius search returns < 8
        (`a_star_on_pc.cpp:241-244`).
      intensity: optional per-node intensity (ground weighting).
    """
    from scipy.spatial import cKDTree

    pts = np.asarray(ground_pts, np.float64)[:, :3]
    g = len(pts)
    tree = cKDTree(pts)
    if intensity is None:
        intensity = np.zeros((g,), np.float32)

    nbr_idx = np.full((g, k_max), -1, np.int64)
    nbr_dist = np.zeros((g, k_max), np.float32)
    avg_int = np.zeros((g,), np.float32)

    neighborhoods = tree.query_ball_point(pts, r=radius)
    # kNN distances for fallback (self included in query results)
    kq = min(orphan_k + 1, g)
    knn_d, knn_i = tree.query(pts, k=kq)

    for i in range(g):
        ids = np.asarray(neighborhoods[i], np.int64)
        if len(ids) < orphan_k:
            ids = np.asarray(knn_i[i], np.int64).ravel()
        d = np.linalg.norm(pts[ids] - pts[i], axis=1)
        # reference keeps self in the successor set (radius search includes
        # the query point) — harmless for relaxation (zero-cost self loop
        # still pays the inflation/node terms); drop it for cleanliness.
        keep = ids != i
        ids, d = ids[keep], d[keep]
        avg_int[i] = (float(np.mean(intensity[np.append(ids, i)]))
                      if len(ids) else float(intensity[i]))
        order = np.argsort(d)[:k_max]
        ids, d = ids[order], d[order]
        nbr_idx[i, : len(ids)] = ids
        nbr_dist[i, : len(ids)] = d

    valid = nbr_idx >= 0
    # Trim all-padding trailing columns: per-row entries are distance-
    # sorted prefixes, so the table's true width is the max row degree.
    # k_max=16 with a typical max degree of 8-12 would make every (G, K)
    # gather in the relaxation/extraction carry 25-50% dead lanes — at
    # fleet scale the (G, K, R, B) relax gather is the single biggest
    # tensor of the tick, so the trim is a direct win everywhere.
    kmax_eff = max(int(valid.sum(axis=1).max()), 1)
    nbr_idx = nbr_idx[:, :kmax_eff]
    nbr_dist = nbr_dist[:, :kmax_eff]
    valid = valid[:, :kmax_eff]
    return GroundGraph(
        nbr_idx=nbr_idx.astype(np.int32),
        nbr_dist=nbr_dist.astype(np.float32),
        nbr_valid=valid,
        avg_intensity=avg_int.astype(np.float32),
        num_nodes=g,
    )


def pad_graph(graph: GroundGraph, pad_to: int) -> GroundGraph:
    """Pad node dimension to a static size (invalid nodes isolated)."""
    g, k = graph.nbr_idx.shape
    assert pad_to >= g
    idx = np.full((pad_to, k), -1, np.int32)
    idx[:g] = graph.nbr_idx
    dist = np.zeros((pad_to, k), np.float32)
    dist[:g] = graph.nbr_dist
    valid = np.zeros((pad_to, k), bool)
    valid[:g] = graph.nbr_valid
    ai = np.zeros((pad_to,), np.float32)
    ai[:g] = graph.avg_intensity
    return GroundGraph(idx, dist, valid, ai, graph.num_nodes)
