"""The lidar measurement likelihood of MCL, batched over robots and
particles.

Counterpart of ``dddmr_navigation_tpu/state_estimation/likelihood.py``
(`LidarMeasurementModelLikelihood::measure`,
`src/lidar_measurement_model_likelihood.cpp:86-253`). The submap is
preprocessed on the host, once, into dense Euclidean distance fields and
a ground-normal raster: :func:`build_distance_field` and
:func:`build_submap_context` are this package's own numpy/SciPy copies of
the JAX package's host code (``likelihood.py:71-296``) and give the same
arrays. Scoring then runs on the device: field samples by gather, and
per particle and feature point the reference's score
``(match_dist_min − max(dist, match_dist_flat))²``, weighted by the
ground-alignment ``pos_weight`` (`:104-192`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from navbench.reference.config import MCLConfig
from navbench.reference.geometry import (
    quat_multiply_fma, quat_normalize, quat_rotate, quat_rotate_fma,
    rpy_from_quat)
from navbench.reference.rounding import fma_dot, fma_norm


class DistanceField(NamedTuple):
    """A dense EDT over a padded AABB, shared by every robot."""
    dist: torch.Tensor                 # (Nx, Ny, Nz) f32
    origin: torch.Tensor               # (3,) world position of voxel (0,0,0)
    res: float
    packed: Optional[torch.Tensor] = None   # (Nx, Ny, ceil(Nz/8), 8)
    near_pt: Optional[torch.Tensor] = None  # (Nx, Ny, Nz, 8): owner xyz,
    #                                          distance, owner normal, pad


class SubmapContext(NamedTuple):
    """A preprocessed submap (`sub_maps.cpp:219-318`'s warm-up output)."""
    map_field: DistanceField
    ground_field: DistanceField
    ground_normal: torch.Tensor        # (Nx, Ny, 3) mean normal near a cell
    ground_count: torch.Tensor         # (Nx, Ny) int32 ground points near it
    ground_xy_res: float
    ground_xy_origin: torch.Tensor     # (2,)


# ---------------------------------------------------------------------------
# host: the submap's fields and rasters (numpy/SciPy, once per submap)
# ---------------------------------------------------------------------------

def _pack_z(edt: np.ndarray) -> np.ndarray:
    """The z-packed (Nx, Ny, ceil(Nz/8), 8) layout, +inf pad lanes."""
    nz = edt.shape[2]
    nz8 = -(-nz // 8)
    return np.pad(edt, ((0, 0), (0, 0), (0, nz8 * 8 - nz)),
                  constant_values=np.inf).reshape(
        edt.shape[0], edt.shape[1], nz8, 8)


def build_distance_field(points: np.ndarray, res: float, pad: float,
                         max_cells: int = 512, pack: bool = True,
                         with_nearest: bool = False,
                         device="cuda") -> DistanceField:
    """The EDT of a point cloud over its padded AABB, built on the host
    and placed on ``device``; with ``with_nearest`` also the owner raster
    of correspondence-cached scoring (per voxel the first cloud point
    binned into its nearest occupied voxel, the distance, and the kNN-PCA
    surface normal at that point)."""
    from scipy import ndimage

    points = np.asarray(points, np.float32)[:, :3]
    mn = points.min(0) - pad
    mx = points.max(0) + pad
    dims = np.minimum(np.ceil((mx - mn) / res).astype(np.int64) + 1,
                      max_cells)
    occ = np.zeros(tuple(dims), bool)
    ci = np.clip(((points - mn) / res).astype(np.int64), 0, dims - 1)
    occ[ci[:, 0], ci[:, 1], ci[:, 2]] = True
    near_pt = None
    origin = (mn + 0.5 * res).astype(np.float32)
    if with_nearest:
        from scipy.spatial import cKDTree

        edt, inds = ndimage.distance_transform_edt(
            ~occ, sampling=res, return_indices=True)
        edt = edt.astype(np.float32)
        rep = np.zeros(tuple(dims) + (3,), np.float32)
        rep[ci[::-1, 0], ci[::-1, 1], ci[::-1, 2]] = points[::-1]
        nn_world = rep[inds[0], inds[1], inds[2]]
        k = int(min(10, len(points)))
        if k >= 3:
            tree = cKDTree(points)
            _, nb = tree.query(points, k=k)
            nbp = points[nb]
            c = nbp - nbp.mean(1, keepdims=True)
            cov = np.einsum("pki,pkj->pij", c, c)
            _, vecs = np.linalg.eigh(cov)
            normals = vecs[:, :, 0].astype(np.float32)
        else:
            normals = np.tile(np.asarray([[0.0, 0.0, 1.0]], np.float32),
                              (len(points), 1))
        repn = np.zeros(tuple(dims) + (3,), np.float32)
        repn[ci[::-1, 0], ci[::-1, 1], ci[::-1, 2]] = normals[::-1]
        nn_normal = repn[inds[0], inds[1], inds[2]]
        pad_lane = np.zeros(edt.shape + (1,), np.float32)
        near_pt = np.concatenate(
            [nn_world, edt[..., None], nn_normal, pad_lane], axis=-1)
    else:
        edt = ndimage.distance_transform_edt(
            ~occ, sampling=res).astype(np.float32)

    def t(a):
        return None if a is None else torch.as_tensor(a, device=device)
    return DistanceField(dist=t(edt), origin=t(origin), res=float(res),
                         packed=t(_pack_z(edt) if pack else None),
                         near_pt=t(near_pt))


def build_submap_context(map_pts: np.ndarray, ground_pts: np.ndarray,
                         cfg: MCLConfig, res: float = 0.15,
                         normal_knn: int = 12, with_nearest: bool = True,
                         device="cuda") -> SubmapContext:
    """Preprocess a submap's map and ground clouds on the host, then place
    them on ``device``: both distance fields, and the ground raster: per
    ground point the kNN-PCA plane normal (|nz|), averaged with the point
    count onto 0.5 m XY cells over the ``radius_of_ground_search``
    neighborhood of each cell center (`sub_maps.cpp:276-300`,
    `lidar_measurement_model_likelihood.cpp:121-126`)."""
    from scipy.spatial import cKDTree

    map_pts = np.asarray(map_pts, np.float32)[:, :3]
    ground_pts = np.asarray(ground_pts, np.float32)[:, :3]
    map_field = build_distance_field(map_pts, res, pad=2.0,
                                     with_nearest=with_nearest,
                                     device=device)
    ground_field = build_distance_field(ground_pts, res, pad=2.0,
                                        with_nearest=with_nearest,
                                        device=device)

    tree = cKDTree(ground_pts)
    k = min(normal_knn, len(ground_pts))
    _, nbr = tree.query(ground_pts, k=k)
    nbrs = ground_pts[nbr]
    c = nbrs - nbrs.mean(1, keepdims=True)
    cov = np.einsum("gki,gkj->gij", c, c)
    _, vecs = np.linalg.eigh(cov)
    normals = vecs[:, :, 0]
    normals[:, 2] = np.abs(normals[:, 2])

    xy_res = 0.5
    mn = ground_pts[:, :2].min(0) - cfg.radius_of_ground_search
    mx = ground_pts[:, :2].max(0) + cfg.radius_of_ground_search
    nx = int(np.ceil((mx[0] - mn[0]) / xy_res)) + 1
    ny = int(np.ceil((mx[1] - mn[1]) / xy_res)) + 1
    cx, cy = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    centers = (np.stack([cx, cy], -1).reshape(-1, 2) * xy_res + mn
               + 0.5 * xy_res)
    tree2 = cKDTree(ground_pts[:, :2])
    idx_lists = tree2.query_ball_point(centers, cfg.radius_of_ground_search)
    avg_n = np.zeros((nx * ny, 3), np.float32)
    cnt = np.zeros((nx * ny,), np.int32)
    for i, lst in enumerate(idx_lists):
        cnt[i] = len(lst)
        if lst:
            avg_n[i] = normals[lst].mean(0)
    return SubmapContext(
        map_field=map_field, ground_field=ground_field,
        ground_normal=torch.as_tensor(avg_n.reshape(nx, ny, 3),
                                      device=device),
        ground_count=torch.as_tensor(cnt.reshape(nx, ny), device=device),
        ground_xy_res=xy_res,
        ground_xy_origin=torch.as_tensor(np.asarray(mn, np.float32),
                                         device=device))


# ---------------------------------------------------------------------------
# device: field samples and particle scores
# ---------------------------------------------------------------------------

def _grid_coords(field: DistanceField, pts):
    """(…, 3) points → (grid coords, grid coords clamped into the field).
    The division is a true one on every device: PyTorch on a card turns a
    division by a Python scalar into a multiply by its reciprocal, which
    moves points on the map's own lattice into the neighboring cell."""
    g = (pts - field.origin) / torch.full((), field.res, device=pts.device)
    gc = torch.stack([torch.clamp(g[..., k], 0.0, float(
        np.float32(d - 1.0) - np.float32(1e-4)))
        for k, d in enumerate(field.dist.shape)], dim=-1)
    return g, gc


def _cell(field: DistanceField, gc):
    """Round-half-even cell indices of clamped coords, inside the field."""
    i = torch.round(gc).long()
    return torch.stack([torch.clamp(i[..., k], max=d - 1)
                        for k, d in enumerate(field.dist.shape)], dim=-1)


def sample_distance(field: DistanceField, pts, method: str = "trilinear"):
    """The EDT at world points (…, 3): trilinear over the eight corners, or
    the one ``nearest`` cell. Outside the grid, the clamped border value
    plus the distance to it (a monotone lower bound)."""
    g, gc = _grid_coords(field, pts)
    oob = fma_norm((g - gc) * field.res)
    d = field.dist
    if method == "nearest":
        i = _cell(field, gc)
        return d[i[..., 0], i[..., 1], i[..., 2]] + oob
    i0 = torch.floor(gc).long()
    f = gc - i0.float()
    fx, fy, fz = f.unbind(-1)
    gx, gy, gz = 1 - fx, 1 - fy, 1 - fz

    def at(dx, dy, dz):
        return d[i0[..., 0] + dx, i0[..., 1] + dy, i0[..., 2] + dz]

    v = (at(0, 0, 0) * gx * gy * gz
         + at(1, 0, 0) * fx * gy * gz
         + at(0, 1, 0) * gx * fy * gz
         + at(0, 0, 1) * gx * gy * fz
         + at(1, 1, 0) * fx * fy * gz
         + at(1, 0, 1) * fx * gy * fz
         + at(0, 1, 1) * gx * fy * fz
         + at(1, 1, 1) * fx * fy * fz)
    return v + oob


def sample_nearest_point(field: DistanceField, pts):
    """The Voronoi owner of each query point's cell (…, 3): (owner xyz,
    field distance at the cell, owner surface normal)."""
    if field.near_pt is None:
        raise ValueError("field built without with_nearest=True")
    _, gc = _grid_coords(field, pts)
    i = _cell(field, gc)
    rows = field.near_pt[i[..., 0], i[..., 1], i[..., 2]]
    return rows[..., :3], rows[..., 3], rows[..., 4:7]


def _roll_diff(quat, normal):
    """The ground-alignment roll residual
    (`lidar_measurement_model_likelihood.cpp:137-165`): tip `up` onto the
    averaged ground normal, take the roll of the tipped pose, and fold it."""
    up = torch.zeros_like(normal)
    up[..., 2] = 1.0
    axis = torch.linalg.cross(normal, up, dim=-1)
    axis = axis / torch.clamp(fma_norm(axis), min=1e-9)[..., None]
    ang = -torch.acos(torch.clamp(fma_dot(normal, up), -1.0, 1.0))
    s, c = torch.sin(0.5 * ang), torch.cos(0.5 * ang)
    q_normal = torch.cat([axis * s[..., None], c[..., None]], dim=-1)
    roll = rpy_from_quat(quat_normalize(quat_multiply_fma(quat, q_normal)))[0]
    ar = torch.abs(roll)
    return torch.where((ar > 2.6) & (ar < np.pi), np.pi - ar,
                       torch.where(ar < 0.5, ar, 0.55))


def _pos_weight(ctx: SubmapContext, cfg: MCLConfig, pos, quat):
    """`lidar_measurement_model_likelihood.cpp:104-192` for particle poses
    (…, 3)/(…, 4). Returns (weight, ground trusted)."""
    ij = ((pos[..., :2] - ctx.ground_xy_origin) / ctx.ground_xy_res).int()
    nx, ny = ctx.ground_count.shape
    i = torch.clamp(ij[..., 0], 0, nx - 1).long()
    j = torch.clamp(ij[..., 1], 0, ny - 1).long()
    cnt = ctx.ground_count[i, j]
    n = ctx.ground_normal[i, j]
    trusted = cnt >= cfg.threshold_for_trusted_ground
    tilted = ((torch.abs(n[..., 0]) >= 3.0 * torch.abs(n[..., 2]))
              | (torch.abs(n[..., 1]) >= 3.0 * torch.abs(n[..., 2])))
    nn = n / torch.clamp(fma_norm(n), min=1e-9)[..., None]
    rd = _roll_diff(quat, nn)
    d_ground = sample_distance(ctx.ground_field, pos)
    w_ground = torch.clamp((1.0 - d_ground) * (1.0 - rd), min=0.01)
    w_trusted = torch.where(tilted, 0.2, w_ground)
    d_map = sample_distance(ctx.map_field, pos)
    w_untrusted = torch.clamp(1.0 - d_map, min=0.01)
    return torch.where(trusted, w_trusted, w_untrusted), trusted


def _to_world(pos, quat, pts):
    """Base-frame feature points (B, F, 3) at particle poses (B, N, 3)/
    (B, N, 4) → (B, N, F, 3). Plain rounding: the scores these feed are
    continuous in the points (only the cached owners' cells, from
    :func:`measure_all_corr`'s reference pose, need XLA's)."""
    return quat_rotate(quat[:, :, None, :], pts[:, None]) + pos[:, :, None, :]


def _scores(cfg: MCLConfig, d_flat, flat_mask, d_sharp, sharp_mask,
            sharp_weight, pos_w):
    """Likelihood and match ratio (B, N) from per-point distances
    (B, N, F)/(B, N, S)."""
    mdm, mdf = cfg.match_dist_min, cfg.match_dist_flat
    fm, sm = flat_mask[:, None], sharp_mask[:, None]
    matched_f = fm & (d_flat <= mdm)
    sc_f = mdm - torch.clamp(d_flat, min=mdf)
    sc_f = torch.where(matched_f & (sc_f >= 0.0), sc_f * sc_f, 0.0)
    matched_s = sm & (d_sharp <= mdm)
    sc_s = mdm - torch.clamp(d_sharp, min=mdf)
    sc_s = torch.where(matched_s & (sc_s >= 0.0),
                       sc_s * sc_s / torch.clamp(sharp_weight, min=1e-6)[:, None],
                       0.0)
    score = (sc_f.sum(dim=2) + sc_s.sum(dim=2)) * pos_w
    total = torch.clamp(flat_mask.sum(dim=1) + sharp_mask.sum(dim=1), min=1)
    num = ((matched_f & (mdm - torch.clamp(d_flat, min=mdf) >= 0)).sum(dim=2)
           + matched_s.sum(dim=2))
    return score, num.float() / total.float()[:, None]


def measure_all(ctx: SubmapContext, cfg: MCLConfig, flat_pts, flat_mask,
                sharp_pts, sharp_mask, sharp_weight, pf_pos, pf_quat):
    """Every particle's likelihood, each feature point sampling the fields
    at its particle-transformed position (``cfg.field_sampling``
    'trilinear' or 'nearest'). Feature clouds (B, F, 3)/(B, S, 3) in the
    base frame with masks; sharp_weight (B, S); particles (B, N, ...).
    Returns (likelihood (B, N), match_ratio (B, N))."""
    method = cfg.field_sampling
    fp = _to_world(pf_pos, pf_quat, flat_pts)
    sp = _to_world(pf_pos, pf_quat, sharp_pts)
    pos_w, trusted = _pos_weight(ctx, cfg, pf_pos, pf_quat)
    d_flat = torch.where(trusted[..., None],
                         sample_distance(ctx.ground_field, fp, method),
                         sample_distance(ctx.map_field, fp, method))
    d_sharp = sample_distance(ctx.map_field, sp, method)
    return _scores(cfg, d_flat, flat_mask, d_sharp, sharp_mask, sharp_weight,
                   pos_w)


def measure_likelihood(ctx: SubmapContext, cfg: MCLConfig, flat_pts,
                       flat_mask, sharp_pts, sharp_mask, sharp_weight, pos,
                       quat):
    """Likelihood and match ratio of ONE particle (the JAX package's
    per-particle function, which it vmaps into ``measure_all``): feature
    clouds (F, 3)/(S, 3) in the base frame with masks, sharp_weight (S,),
    the pose (3,)/(4,). Returns two scalars."""
    score, ratio = measure_all(
        ctx, cfg, flat_pts[None], flat_mask[None], sharp_pts[None],
        sharp_mask[None], sharp_weight[None], pos[None, None],
        quat[None, None])
    return score[0, 0], ratio[0, 0]

def measure_all_corr(ctx: SubmapContext, cfg: MCLConfig, flat_pts, flat_mask,
                     sharp_pts, sharp_mask, sharp_weight, pf_pos, pf_quat,
                     pose0_pos, pose0_quat):
    """Correspondence-cached scoring (``field_sampling='corr'``): each
    feature point's owner is looked up once, at the odometry-predicted
    pose ``pose0`` (B, 3)/(B, 4), and every particle scores the
    point-to-plane distance ``max(|Δ·n̂|, |Δ| − r_patch)`` to it. Arguments
    and result as :func:`measure_all`."""
    r_patch = cfg.corr_patch_cells * ctx.map_field.res

    def ref(pts):
        return (quat_rotate_fma(pose0_quat[:, None, :], pts)
                + pose0_pos[:, None, :])
    fp0, sp0 = ref(flat_pts), ref(sharp_pts)
    nn_fg, _, n_fg = sample_nearest_point(ctx.ground_field, fp0)
    nn_fm, _, n_fm = sample_nearest_point(ctx.map_field, fp0)
    nn_sm, _, n_sm = sample_nearest_point(ctx.map_field, sp0)

    def pp_dist(q, nn, nrm):
        delta = q - nn[:, None]
        along = torch.abs(fma_dot(delta, nrm[:, None]))
        return torch.maximum(along, fma_norm(delta) - r_patch)

    fp = _to_world(pf_pos, pf_quat, flat_pts)
    sp = _to_world(pf_pos, pf_quat, sharp_pts)
    pos_w, trusted = _pos_weight(ctx, cfg, pf_pos, pf_quat)
    d_flat = torch.where(trusted[..., None], pp_dist(fp, nn_fg, n_fg),
                         pp_dist(fp, nn_fm, n_fm))
    d_sharp = pp_dist(sp, nn_sm, n_sm)
    return _scores(cfg, d_flat, flat_mask, d_sharp, sharp_mask, sharp_weight,
                   pos_w)
