"""Inputs built to probe the kernels' culls where they could go wrong, from
a seed, as numpy arrays (the tests and ``chip_smoke.py`` both use them).

* :func:`box_inputs` — ``swept_box_hits`` arguments: rollout-like rows
  (consecutive steps along arcs, so that warp tiles are tight), obstacles
  exactly on box faces and corners and at the cull's sphere radius ± its
  margin, a robot at coordinates of order 100 m, a robot whose obstacles are
  all invalid, and a robot whose axes are scaled or sheared off unit length;
  the shapes are ragged against the kernel's tiles and obstacle chunks.
* :func:`dist_inputs` — ``masked_min_distance`` arguments: points at ±1 ulp
  around a query's nearest point, a robot at coordinates of order 100 m, a
  robot with no valid point and one with no unmasked query; ``q`` picks
  the kernel's narrow or wide variant.
"""
from __future__ import annotations

import numpy as np

HALF = (0.385, 0.36, 0.3)   # the default footprint's half extents, m


def _rotations(rng, shape):
    """Random f32 rotation matrices (rows are the box axes)."""
    q = np.linalg.qr(rng.normal(size=(*shape, 3, 3)))[0]
    return np.ascontiguousarray(np.swapaxes(q, -1, -2), np.float32)


def box_inputs(seed: int, b: int = 4, s: int = 37, n: int = 13,
               k: int = 300, half=HALF):
    """(axes, projc, step_valid, obstacles, obs_valid) for
    ``swept_box_hits``. Robot 0 lies near the origin, robot 1 around
    (100, -80, 3) m, robot 2 has every obstacle invalid, robot 3 has axes
    scaled by 1.001 on some rows and sheared past the cull's limit on
    others."""
    rng = np.random.default_rng(seed)
    h = np.asarray(half, np.float64)
    origin = np.zeros((b, 3))
    origin[1] = (100.0, -80.0, 3.0)
    # rows along arcs: sample j drives at speed v_j and turn rate w_j
    v = rng.uniform(0.0, 1.0, size=(b, s))
    w = rng.uniform(-1.0, 1.0, size=(b, s))
    t = 0.3 * np.arange(1, n + 1)
    yaw = w[..., None] * t                                     # (b,s,n)
    cx = np.cumsum(v[..., None] * np.cos(yaw) * 0.3, axis=-1)
    cy = np.cumsum(v[..., None] * np.sin(yaw) * 0.3, axis=-1)
    centers = np.stack([cx, cy, np.full_like(cx, 0.3)], -1) + origin[:, None,
                                                                     None]
    c, sn = np.cos(yaw), np.sin(yaw)
    axes = np.zeros((b, s, n, 3, 3))
    axes[..., 0, 0], axes[..., 0, 1] = c, sn
    axes[..., 1, 0], axes[..., 1, 1] = -sn, c
    axes[..., 2, 2] = 1.0
    tilt = _rotations(rng, (b, s, n)).astype(np.float64)
    mix = rng.uniform(size=(b, s, n)) < 0.3        # some rows fully rotated
    axes = np.where(mix[..., None, None], tilt, axes)
    axes[3, ::2] *= 1.001                           # not quite unit length
    axes[3, 1::4, :, 0] += 0.8                      # sheared: no cull there
    axes = axes.astype(np.float32)
    a64 = axes.astype(np.float64)
    projc = np.einsum("bsnkj,bsnj->bsnk", a64, centers).astype(np.float32)
    step_valid = rng.uniform(size=(b, s, n)) < 0.85

    # obstacles: on faces, corners and the sphere radius of random late
    # rows of the fast samples, the rest scattered ahead of the robot, so
    # that the slow samples, whose boxes stay near the start, hit nothing
    obstacles = np.empty((b, k, 3))
    signs = rng.integers(-1, 2, size=(b, k, 3)).astype(np.float64)
    corner = rng.uniform(size=(b, k)) < 0.5
    signs[corner] = rng.choice([-1.0, 1.0], size=(int(corner.sum()), 3))
    bi = np.arange(b)[:, None]
    fast = np.argsort(v, axis=1)[:, -max(1, s // 3):]          # (b, s/3)
    rs = fast[bi, rng.integers(0, fast.shape[1], size=(b, k))]
    rn = rng.integers(n // 2, n, size=(b, k))
    a_row = a64[bi, rs, rn]                                    # (b,k,3,3)
    x0 = np.einsum("bkij,bki->bkj", a_row,
                   projc[bi, rs, rn].astype(np.float64))
    on_box = x0 + np.einsum("bki,bkij->bkj", signs * h, a_row)
    u = rng.normal(size=(b, k, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    hn = np.linalg.norm(h)
    # the row sphere's radius with the margins (csrc/swept_box_hits.cu),
    # and ± that margin
    r = hn + 1e-3 + 1e-5 * (np.linalg.norm(x0, axis=-1) + hn)
    r = r * rng.choice([1.0, 1.0 - 1e-6, 1.0 + 1e-6, 0.999, 1.001],
                       size=(b, k))
    on_sphere = x0 + u * r[..., None]
    scattered = (origin[:, None] + rng.uniform([1.5, -5.0, -0.2],
                                               [8.0, 5.0, 1.0],
                                               size=(b, k, 3)))
    kind = rng.integers(0, 3, size=(b, k))
    obstacles = np.where((kind == 0)[..., None], on_box,
                         np.where((kind == 1)[..., None], on_sphere,
                                  scattered)).astype(np.float32)
    obs_valid = rng.uniform(size=(b, k)) < 0.9
    obs_valid[2] = False
    return axes, projc, step_valid, obstacles, obs_valid


def dist_inputs(seed: int, b: int = 4, q: int = 1000, m: int = 600):
    """(queries, q_mask, points, p_mask) for ``masked_min_distance``.
    Robot 0 lies near (12, 12, 0) m, robot 1 around (100, -80, 3) m with
    points at ±1 ulp around its queries' nearest points, robot 2 has no
    valid point (and five queries at the parking point of invalid points,
    1e6 m out), robot 3 no unmasked query. ``m`` above 512 spans two of
    the kernel's point chunks; ``b * q`` from 2**17 takes its wide
    variant. Needs ``b >= 4``."""
    if b < 4:
        raise ValueError(f"dist_inputs needs b >= 4, got {b}")
    rng = np.random.default_rng(seed)
    origin = np.array([[12.0, 12.0, 0.0], [100.0, -80.0, 3.0],
                       [0.0, 0.0, 0.0], [5.0, 5.0, 0.0]])[np.arange(b) % 4]
    # queries along arcs, as the stick-path critic's rollout steps are
    steps = rng.normal(scale=0.05, size=(b, q, 3)) * [1.0, 1.0, 0.1]
    queries = (origin[:, None] + np.cumsum(steps, axis=1)).astype(np.float32)
    # a plan: a path of points, some near the queries, later ones far
    path = rng.normal(scale=0.1, size=(b, m, 3)) * [1.0, 1.0, 0.1]
    points = (origin[:, None] + np.cumsum(path, axis=1)).astype(np.float32)
    # ±1 ulp around the nearest point of some queries of robot 1 (and of
    # every robot when there are more than four)
    for r in range(1, b, 4):
        pick = rng.choice(q, size=min(q, 40), replace=False)
        d2 = ((queries[r, pick, None].astype(np.float64)
               - points[r, None].astype(np.float64)) ** 2).sum(-1)
        nearest = points[r, d2.argmin(1)]                       # (40, 3)
        slots = rng.choice(m, size=min(m, 3 * len(pick)), replace=False)
        for i, slot in enumerate(slots):
            p = nearest[i % len(pick)].copy()
            axis = i % 3
            toward = np.inf if (i // 3) % 2 else -np.inf
            p[axis] = np.nextafter(p[axis], np.float32(toward))
            points[r, slot] = p
    q_mask = rng.uniform(size=(b, q)) < 0.8
    p_mask = rng.uniform(size=(b, m)) < 0.7
    p_mask[2] = False
    q_mask[3] = False
    # queries at the parking point of invalid points: their distance is 0
    queries[2, :5] = 1.0e6
    q_mask[2, :5] = True
    return queries, q_mask, points, p_mask
