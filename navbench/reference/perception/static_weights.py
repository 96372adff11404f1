"""Static-layer node weights + overhang lethal — TPU re-design of
``StaticLayer::radiusSearchConnection``
(`plugins/static_layer.cpp:286-421`).

The port's own copy of ``dddmr_navigation_tpu/perception/static_weights.py``
(numpy and SciPy only).

Per ground node the reference:
  1. gathers a connection neighborhood (fixed radius or adaptive-k),
  2. <5 neighbors ⇒ orphan weight 1000,
  3. else fits a plane (RANSAC) through the neighborhood, samples polar
     rings (radii ``intensity_search_radius`` down to 0 in 0.25 steps ×
     36 thetas) on that plane, and counts ring samples with NO ground
     within 0.3 m — each miss adds ``intensity_search_punish_weight``
     (boundary nodes get punished, interior nodes stay ~1),
  4. marks the node lethal in the static dGraph (0.25) when >10 map
     points sit in the z-passthrough box above it (overhang).

This is one-time map preprocessing; host NumPy/SciPy, deterministic
least-squares plane fit in place of RANSAC (the neighborhoods are
already-filtered ground, so a robust estimator changes nothing on the
bundled maps — parity is on the resulting weights).
"""
from __future__ import annotations

import numpy as np

from navbench.reference.config import StaticLayerConfig


def compute_node_weights(ground_pts: np.ndarray,
                         map_pts: np.ndarray | None = None,
                         cfg: StaticLayerConfig | None = None,
                         max_obstacle_distance: float = 9999.0):
    """Returns (node_weight (G,), static_dgraph (G,)).

    node_weight feeds the A* cost's ``+ node_weight`` term
    (`a_star_on_pc.cpp:288`); static_dgraph carries the overhang lethal
    (0.25 < inscribed_radius ⇒ pruned) and is min-composed with the
    dynamic layers' distance fields.
    """
    from scipy.spatial import cKDTree

    cfg = cfg or StaticLayerConfig()
    pts = np.asarray(ground_pts, np.float64)[:, :3]
    g = len(pts)
    tree = cKDTree(pts)
    weights = np.ones((g,), np.float32)
    static_dgraph = np.full((g,), max_obstacle_distance, np.float32)

    if cfg.use_adaptive_connection:
        # grow the radius until ≥ adaptive_connection_number neighbors
        neighborhoods = []
        for i in range(g):
            r, cnt = 0.7, 1
            idx = tree.query_ball_point(pts[i], r)
            while len(idx) < cfg.adaptive_connection_number and cnt < 100:
                cnt += 1
                idx = tree.query_ball_point(pts[i], 0.5 + 0.2 * cnt)
            neighborhoods.append(idx)
    else:
        neighborhoods = tree.query_ball_point(
            pts, cfg.radius_of_ground_connection)

    # ring sample offsets (shared): radius × theta grid on the local plane
    radii = np.arange(cfg.intensity_search_radius, 0, -0.25)
    thetas = np.arange(-np.pi, np.pi + 1e-6, 0.174)
    ring_xy = np.stack([
        np.repeat(radii, len(thetas)) * np.sin(np.tile(thetas, len(radii))),
        np.repeat(radii, len(thetas)) * np.cos(np.tile(thetas, len(radii))),
    ], axis=1)                                            # (S, 2)

    map_tree = None
    if map_pts is not None and len(map_pts):
        mp = np.asarray(map_pts, np.float64)[:, :3]
        map_tree = cKDTree(mp)

    for i in range(g):
        idx = neighborhoods[i]
        nn = pts[idx]
        if len(nn) < 5:
            weights[i] = 1000.0
            continue
        # least-squares plane z = ax + by + d
        A = np.column_stack([nn[:, 0], nn[:, 1], np.ones(len(nn))])
        coef, *_ = np.linalg.lstsq(A, nn[:, 2], rcond=None)
        sx = pts[i, 0] + ring_xy[:, 0]
        sy = pts[i, 1] + ring_xy[:, 1]
        sz = coef[0] * sx + coef[1] * sy + coef[2]
        samples = np.column_stack([sx, sy, sz])
        d, _ = tree.query(samples, k=1)
        reject = int(np.sum(d > 0.3))
        weights[i] = 1.0 + reject * cfg.intensity_search_punish_weight

        if map_tree is not None:
            # overhang: >10 map points in the ±0.5 XY box, z+0.1..z+1.0
            cand = map_tree.query_ball_point(pts[i], cfg.static_imposing_radius)
            if cand:
                c = np.asarray(map_tree.data)[cand]
                in_box = ((np.abs(c[:, 0] - pts[i, 0]) <= 0.5)
                          & (np.abs(c[:, 1] - pts[i, 1]) <= 0.5)
                          & (c[:, 2] >= pts[i, 2] + 0.1)
                          & (c[:, 2] <= pts[i, 2] + 1.0))
                if int(in_box.sum()) > 10:
                    static_dgraph[i] = 0.25
    return weights, static_dgraph
