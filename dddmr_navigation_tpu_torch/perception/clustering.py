"""Euclidean cluster extraction on the window grid, batched over robots.

Counterpart of ``dddmr_navigation_tpu/perception/clustering.py``: connected
components by iterated min-label propagation (the reference's PCL
EuclideanClusterExtraction, `multilayer_spinning_lidar.cpp:327-336`), and a
padded (max_clusters,) table of centroids and sizes.
"""
from __future__ import annotations

import torch

from dddmr_navigation_tpu_torch.ops.compaction import first_k_true_indices


def _linear_index(shape, device):
    x, y, z = shape
    return torch.arange(x * y * z, dtype=torch.int32, device=device).view(x, y, z)


def label_components(occ, tol_cells: int = 2, num_iters: int = 24):
    """Label connected components of each robot's occupancy (B, X, Y, Z).

    Every occupied cell starts with its linear index; each sweep takes the
    min label over the (2·tol+1)³ cube, as three 1-D window mins. The JAX
    loop stops at the label fixpoint or after ``num_iters`` sweeps, per
    robot; here every robot takes exactly ``num_iters`` sweeps, with no
    host read of a "done" flag (so a CUDA graph can capture the loop).
    The labels are the same: at the fixpoint a sweep changes nothing.

    Returns (B, X, Y, Z) int32 labels, -1 where unoccupied.
    """
    labels, sweep = _label_sweep(occ, tol_cells)
    for _ in range(num_iters):
        labels = sweep(labels)
    return torch.where(occ.bool(), labels, -1)


def _label_sweep(occ, tol_cells: int):
    """(the start labels, one sweep) of :func:`label_components`: each
    occupied cell's linear index, ``x·y·z + 1`` where unoccupied."""
    occ = occ.bool()
    x, y, z = occ.shape[1:]
    big = x * y * z + 1
    labels = torch.where(occ, _linear_index((x, y, z), occ.device), big)

    def axis_min(a, dim):
        out = a
        n = a.shape[dim]
        for d in range(1, tol_cells + 1):
            pad_shape = list(a.shape)
            pad_shape[dim] = d
            pad = a.new_full(pad_shape, big)
            out = torch.minimum(out, torch.cat([a.narrow(dim, d, n - d), pad],
                                               dim=dim))
            out = torch.minimum(out, torch.cat([pad, a.narrow(dim, 0, n - d)],
                                               dim=dim))
        return out

    def sweep(lbl):
        prop = lbl
        for dim in (1, 2, 3):
            prop = axis_min(prop, dim)
        return torch.where(occ, torch.minimum(lbl, prop), big)

    return labels, sweep


def label_components_pooled(occ, pool: int, num_iters: int = 24):
    """Label on a ``pool``×-downsampled grid (the reference's 0.1 m
    clustering lattice at a 0.05 m grid) with a 1-cell tolerance.

    Returns (labels (B, X, Y, Z) int32 in pooled-linear-id space, -1 where
    unoccupied; root_mask (B, Xp*Yp*Zp) bool, the pooled root cells).
    """
    occ = occ.bool()
    b, x, y, z = occ.shape
    p = pool
    xp, yp, zp = -(-x // p), -(-y // p), -(-z // p)
    padded = torch.nn.functional.pad(
        occ, (0, zp * p - z, 0, yp * p - y, 0, xp * p - x))
    occ_p = padded.view(b, xp, p, yp, p, zp, p).any(6).any(4).any(2)
    lab_p = label_components(occ_p, tol_cells=1, num_iters=num_iters)
    root = (occ_p & (lab_p == _linear_index((xp, yp, zp), occ.device))
            ).view(b, -1)
    # each pooled label repeated p times along every axis (an expand, where
    # repeat_interleave may copy its repeats to the device)
    up = lab_p[:, :, None, :, None, :, None].expand(
        b, xp, p, yp, p, zp, p).reshape(b, xp * p, yp * p, zp * p)[
            :, :x, :y, :z]
    return torch.where(occ, up, -1), root


def cluster_table(labels, occ, cell_pos, max_clusters: int, root_mask=None):
    """Reduce labeled cells to a padded cluster table per robot.

    Args:
      labels: (B, X, Y, Z) int32 from :func:`label_components` (or the
        pooled variant, with its ``root_mask``).
      occ: (B, X, Y, Z) occupancy.
      cell_pos: (B, X, Y, Z, 3) world position of each cell.
      max_clusters: table size K.

    Returns:
      centroids: (B, K, 3) f32 (garbage rows where invalid)
      sizes: (B, K) int32 cell count (0 where invalid)
      cell_cluster_idx: (B, X, Y, Z) int64 table index (-1 unoccupied or
        an overflowed cluster).
    """
    b = labels.shape[0]
    flat_labels = labels.reshape(b, -1)
    flat_occ = occ.reshape(b, -1).bool()
    flat_pos = cell_pos.reshape(b, -1, 3)
    if root_mask is None:
        lin = torch.arange(flat_labels.shape[1], dtype=flat_labels.dtype,
                           device=labels.device)
        root_mask = flat_occ & (flat_labels == lin)
    uniq0 = first_k_true_indices(root_mask, max_clusters)         # (B, K)
    valid_cluster = uniq0 >= 0
    uniq = torch.where(valid_cluster, uniq0, torch.iinfo(torch.int32).max)

    eq = ((flat_labels[:, :, None] == uniq[:, None, :])
          & flat_occ[:, :, None]).float()                         # (B, N, K)
    matched = eq.amax(dim=2) > 0
    idx = torch.where(matched, torch.argmax(eq, dim=2), max_clusters)

    # The segment sums as one one-hot matmul, as the JAX package does it,
    # but in f64 and rounded once: an f32 sum's rounding depends on the
    # order, which cuBLAS, MKL and XLA each choose their own way, and the
    # centroids feed the 0.05 m ground-attach gate and the static-map
    # lookup. The f64 sum of a few thousand f32 positions is exact to far
    # below an f32 ulp, so every order gives the same centroids.
    vals = torch.cat([torch.where(matched[..., None], flat_pos, 0.0),
                      flat_occ[..., None].float()], dim=-1)       # (B, N, 4)
    acc = torch.matmul(eq.transpose(1, 2).double(), vals.double()).float()
    sizes = acc[..., 3].int() * valid_cluster
    centroids = acc[..., :3] / torch.clamp(sizes, min=1)[..., None]
    cell_cluster_idx = torch.where(matched, idx, -1).view(labels.shape)
    return centroids, sizes, cell_cluster_idx
