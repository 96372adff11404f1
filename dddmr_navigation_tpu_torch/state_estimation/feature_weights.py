"""Per-scan feature-weight preprocessing for MCL, the counterpart of
``dddmr_navigation_tpu/state_estimation/feature_weights.py``
(``MCL3dlNode::cbLeGoFeatureCloud``'s reweighting stage,
`src/mcl_3dl.cpp:300-443`).

Per LeGO-LOAM feature scan of P padded points:
  * the flat (ground) features are voxel-downsampled at 1×1×0.1 m;
  * kNN(5) normals are estimated on the less-sharp cloud;
  * when the environment is **normal-dominant** (Σ|nx|/Σ|ny| ≥ 1.6 or the
    reverse: long parallel walls), features whose signed normal ratio
    crosses 0.5 get weight ``0.05·Σ|n_other|/Σ|n_dom|``, all others 1.0;
  * otherwise the cloud is Euclidean-clustered (tolerance
    ``euc_cluster_distance``, min size ``euc_cluster_min_size``) and every
    point weighs ``cluster_size/total`` (halved for clusters of exactly
    the minimum size; smaller clusters are dropped).

Every step is a fixed-shape tensor op: the voxel keys sort by three
stable sorts, the kNN is a stable sort of the squared distances (so ties
go to the lower index, as ``lax.top_k`` breaks them), and the clusters
come from a fixed 16 iterations of min-label propagation with pointer
doubling, with no host read. The normals come from ``torch.linalg.eigh``
(LAPACK on the CPU; on the card cuSOLVER, which reads its ``info`` back:
the one host sync); the viewpoint flip fixes their sign.
"""
from __future__ import annotations

import torch

from dddmr_navigation_tpu_torch.config import MCLConfig
from dddmr_navigation_tpu_torch.rounding import fma_dot

_BIG = 1.0e12


def voxel_downsample_flat(pts, mask, leaf=(1.0, 1.0, 0.1)):
    """Keep the first valid point of each voxel cell, in lexicographic
    (x, y, z) cell order (PCL's VoxelGrid keeps the centroid; the first
    point keeps the shapes static and lies within half a leaf). ``pts``
    (P, 3), ``mask`` (P,). Returns (pts, new mask)."""
    p = pts.shape[0]
    # a true division by a device tensor, as the JAX package divides (on
    # the card a Python divisor becomes a reciprocal multiply); filled on
    # the device, so no host copy waits
    leaf_t = torch.stack([torch.full((), c, device=pts.device)
                          for c in leaf])
    cells = torch.floor(pts / leaf_t).to(torch.int32)
    # invalid rows get unique sentinel cells, so they never merge a voxel
    sentinel = (1 << 20) + torch.arange(p, dtype=torch.int32,
                                        device=pts.device)
    cx = torch.where(mask, cells[:, 0], sentinel)
    cy = torch.where(mask, cells[:, 1], 0)
    cz = torch.where(mask, cells[:, 2], 0)
    # lexsort((cz, cy, cx)): stable sorts from the last key to the first
    order = torch.sort(cz, stable=True).indices
    order = order[torch.sort(cy[order], stable=True).indices]
    order = order[torch.sort(cx[order], stable=True).indices]
    sx, sy, sz = cx[order], cy[order], cz[order]
    first = torch.cat([
        torch.ones((1,), dtype=torch.bool, device=pts.device),
        (sx[1:] != sx[:-1]) | (sy[1:] != sy[:-1]) | (sz[1:] != sz[:-1])])
    keep = torch.zeros_like(mask).scatter(0, order, first)
    return pts, keep & mask


def _knn(pts, mask, k: int):
    """(P, k) indices of each point's k nearest valid points (itself
    first), ties to the lower index."""
    d = pts[:, None, :] - pts[None, :, :]
    d2 = fma_dot(d, d)
    d2 = torch.where(mask[None, :] & mask[:, None], d2, _BIG)
    return torch.sort(d2, dim=1, stable=True).indices[:, :min(k, pts.shape[0])]


def knn_normals(pts, mask, k: int = 5):
    """Masked kNN PCA normals (the reference's pcl::NormalEstimation with
    setKSearch(5)): (P, 3) unit normals, undefined where the mask is
    false, oriented toward the sensor origin (PCL's
    ``flipNormalTowardsViewpoint`` with viewpoint (0, 0, 0)): the
    dominance reweighting reads the signed components."""
    idx = _knn(pts, mask, k)
    nbrs = pts[idx]                                          # (P, k, 3)
    c = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = torch.einsum("pki,pkj->pij", c, c)
    _, vecs = torch.linalg.eigh(cov)
    n = vecs[:, :, 0]
    n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                        min=1e-9)
    flip = (-pts * n).sum(dim=-1) < 0.0
    return torch.where(flip[:, None], -n, n)


def label_clusters(pts, mask, tol: float, iters: int = 16):
    """ε-graph connected components by min-label propagation with pointer
    doubling: each iteration takes the neighbours' minimum, then jumps
    ``lbl = lbl[lbl]``, so a chain of length L settles in O(log L)
    iterations; 16 cover any padded cloud. Returns int32 labels (P,),
    invalid points labelled P."""
    p = pts.shape[0]
    d = pts[:, None, :] - pts[None, :, :]
    adj = (fma_dot(d, d) <= tol * tol) & mask[None, :] & mask[:, None]
    big = torch.full((), p, dtype=torch.int32, device=pts.device)
    lbl = torch.where(mask, torch.arange(p, dtype=torch.int32,
                                         device=pts.device), big)
    for _ in range(iters):
        nb = torch.where(adj, lbl[None, :], big)
        lbl = torch.minimum(lbl, nb.amin(dim=1))
        jumped = lbl[torch.clamp(lbl, max=p - 1).long()]
        lbl = torch.where(lbl < p, torch.minimum(lbl, jumped), lbl)
    return lbl


def sharp_feature_weights(cfg: MCLConfig, pts, mask):
    """Weights of the less-sharp features (`mcl_3dl.cpp:339-443`).
    Returns (weights (P,) f32, keep mask (P,) bool)."""
    p = pts.shape[0]
    normals = knn_normals(pts, mask, k=5)
    nx_s, ny_s = normals[:, 0], normals[:, 1]
    sum_x = torch.where(mask, torch.abs(nx_s), 0.0).sum()
    sum_y = torch.where(mask, torch.abs(ny_s), 0.0).sum()
    eps = 1e-9
    x_dom = sum_x / torch.clamp(sum_y, min=eps) >= 1.6
    y_dom = sum_y / torch.clamp(sum_x, min=eps) >= 1.6

    # dominant branch: down-weight wall-parallel features, by the SIGNED
    # ratios as the reference divides the raw components
    # (`mcl_3dl.cpp:377-398`); a tiny denominator gives ±big, as the
    # reference's IEEE ±inf compares against 0.5
    def safe(d):
        return torch.where(torch.abs(d) < eps,
                           torch.where(d < 0, -eps, eps), d)
    y2x = ny_s / safe(nx_s)
    x2y = nx_s / safe(ny_s)
    w_xdom = torch.where(y2x >= 0.5,
                         0.05 * sum_y / torch.clamp(sum_x, min=eps), 1.0)
    w_ydom = torch.where(x2y >= 0.5,
                         0.05 * sum_x / torch.clamp(sum_y, min=eps), 1.0)
    w_dom = torch.where(x_dom, w_xdom, w_ydom)

    # cluster branch: per-cluster normalized weight
    labels = label_clusters(pts, mask, cfg.euc_cluster_distance).long()
    sizes = torch.zeros(p + 1, dtype=torch.int32, device=pts.device)
    sizes = sizes.scatter_add(0, labels, torch.ones_like(labels,
                                                         dtype=torch.int32))
    csize = sizes[torch.clamp(labels, 0, p - 1)].to(torch.float32)
    total = torch.clamp(mask.sum(), min=1).to(torch.float32)
    w_clu = csize / total
    small = csize < (cfg.euc_cluster_min_size + 1)
    w_clu = torch.where(small, w_clu * 0.5, w_clu)
    keep_clu = csize >= cfg.euc_cluster_min_size      # EC min-size filter

    dominant = x_dom | y_dom
    w = torch.where(dominant, w_dom, w_clu)
    keep = mask & (dominant | keep_clu)
    return torch.where(keep, w, 1.0), keep


def preprocess_features(cfg: MCLConfig, flat_pts, flat_mask, sharp_pts,
                        sharp_mask):
    """The whole per-scan preprocessing: the flat voxel filter and the
    sharp weights. Returns (flat_pts, flat_mask, sharp_pts, sharp_mask,
    sharp_weight)."""
    flat_pts, flat_mask = voxel_downsample_flat(flat_pts, flat_mask)
    w, keep = sharp_feature_weights(cfg, sharp_pts, sharp_mask)
    return flat_pts, flat_mask, sharp_pts, keep, w
