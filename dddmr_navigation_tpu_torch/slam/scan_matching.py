"""Gauss-Newton lidar odometry, the counterpart of
``dddmr_navigation_tpu/slam/scan_matching.py``: lego_loam's scan-to-scan
(`featureAssociation.cpp:1254-1460`) and scan-to-map
(`mapOptimization.cpp:1407-1780`) optimizers, and the loop-closure ICP
(`opt_icp_gn/optimized_ICP_GN.cpp:1-137`).

Correspondences are brute-force nearest neighbours: an (Ns, Nt) squared
distance matrix ``|a|² + |b|² − 2a·b``, recentred on the target mean. The
JAX package pads the scan-to-map submap with points at 1e6, which pull
that mean to ~1e5–1e6: the expansion then cancels down to its rounding,
many distances clamp to 0, and the picks among them are ties. So the
port computes the matrix bit for bit as XLA on the CPU does, on the CPU
and on the card: the mean as XLA's tree of 32-wide windows
(``rounding.mean_rows_xla``, once per call: the targets do not move), the
norms and the cross term as FMA chains (``rounding.fma_dot``, where a
matmul would sum in cuBLAS's order). The k nearest are a stable sort of
each row, so ties go to the lower index as ``lax.top_k`` breaks them;
masked targets are ``inf`` and are taken only when fewer than k are valid,
gathering the padding. The 6-dof update is
Gauss-Newton on a left-multiplied twist (rotvec, translation) with the
Jacobian from ``torch.func.jacfwd`` at ξ = 0 (forward mode, as
``jax.jacfwd``), a Marquardt-damped 6 × 6 solve (``solve_ex``: no host
read of LAPACK's ``info``) and a trust-region clip; ``match_to_map``
projects out degenerate directions with ``eigh`` (sign-invariant: the
projector ``V·diag(keep)·Vᵀ``). The iterations are a Python loop with
re-matching inside, as the JAX package's ``fori_loop``.

Pose convention: ``(pos (3,), quat (4,))`` maps source-frame points into
the target frame: ``x_t = R x_s + t``.
"""
from __future__ import annotations

import torch
from torch.func import jacfwd

from dddmr_navigation_tpu_torch.config import SlamConfig
from dddmr_navigation_tpu_torch.geometry import (
    quat_exp, quat_multiply, quat_normalize, quat_rotate, quat_rotate_fma)
from dddmr_navigation_tpu_torch.rounding import (
    f32, fma, fma_dot, fma_norm, mean_rows_xla, recip)

K_NN = 8


def _targets(tgt, tgt_mask):
    """What the squared distances to ``tgt`` need of it alone, once a call
    (the targets do not move between iterations): the points, their mask,
    the target mean (:func:`rounding.mean_rows_xla`), the points recentred
    on it and their squared norms."""
    c = mean_rows_xla(tgt)
    b = tgt - c
    return tgt, tgt_mask, c, b, fma_dot(b, b)


def _knn(src, targets, k: int):
    """k nearest targets per source point → (idx (Ns, k), d2 (Ns, k)),
    nearest first, ties to the lower index. The squared distances
    ``|a|² + |b|² − 2a·b``, recentred on the target mean, are XLA's on the
    CPU bit for bit: the norms and the cross term FMA chains."""
    _, tgt_mask, c, b, b2 = targets
    a = src - c
    cross = fma_dot(a[:, None, :], b[None, :, :])
    d2 = torch.clamp(fma_dot(a, a)[:, None] + b2[None, :] - 2.0 * cross,
                     min=0.0)
    d2 = torch.where(tgt_mask[None, :], d2, float("inf"))
    if k == 1:
        d, i = torch.min(d2, dim=1, keepdim=True)
        return i, d
    d, i = torch.sort(d2, dim=1, stable=True)
    return i[:, :k], d[:, :k]


def _apply(pos, quat, pts):
    """Points moved by the pose, rounded as XLA's jitted ``quat_rotate``
    (a source point's distances to the submap cancel down to its
    rounding)."""
    return quat_rotate_fma(quat[None, :], pts) + pos[None, :]


def _safe_norm(v, eps=1e-12):
    """norm with a well-defined derivative at 0 (jacfwd runs at ξ = 0)."""
    return torch.sqrt((v * v).sum(dim=-1) + eps)


def _twist(xi, base):
    """Left-multiplied twist update exp(ξ)·T applied to points ``base``
    already moved by T, ξ = (rotvec(3), dt(3)). Only ξ varies under
    ``jacfwd``: the moved points, the lines and the planes are computed
    once an iteration (at ξ = 0 the rotation is the identity, so the
    residual's values are those of the moved points exactly)."""
    dq = quat_exp(xi[:3])
    return quat_rotate(dq[None, :], base) + xi[None, 3:]


def _unit(d):
    return d / (torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-9)


def _line_residuals(p, la, dn):
    """Point-to-line distance of p to the line through la along dn."""
    v = p - la
    perp = v - (v * dn).sum(dim=-1, keepdim=True) * dn
    return _safe_norm(perp)


def _plane_residuals(p, pa, n):
    """Signed point-to-plane distance of p to the plane (pa, n)."""
    return ((p - pa) * n).sum(dim=-1)


def _gn_step(pos, quat, residual_fn, r, weights, damping=1e-4,
             lm_lambda=0.05, max_rot=0.2, max_trans=0.3, degen_thresh=None):
    """One damped Gauss-Newton step on the 6-twist. ``residual_fn``: ξ →
    (R,); ``r`` its value at ξ = 0.

    Marquardt diagonal scaling shrinks weakly observed directions and the
    step is trust-region clipped per iteration, as the reference's
    `iterCount` loop takes small steps (`featureAssociation.cpp:1254-1460`).
    ``degen_thresh``: the scan-to-map degeneracy guard
    (`mapOptimization.cpp` LMOptimization isDegenerate): the update's
    components along JᵀJ eigendirections below the threshold are projected
    out."""
    xi0 = torch.zeros((6,), dtype=torch.float32, device=pos.device)
    J = jacfwd(residual_fn)(xi0)                    # (R, 6)
    Jw = J * weights[:, None]
    JtJ = Jw.T @ J
    Jtr = Jw.T @ r
    eye = torch.eye(6, dtype=torch.float32, device=pos.device)
    JtJ_d = JtJ + lm_lambda * torch.diag(torch.diagonal(JtJ)) + damping * eye
    xi = -torch.linalg.solve_ex(JtJ_d, Jtr)[0]
    if degen_thresh is not None:
        evals, evecs = torch.linalg.eigh(JtJ)
        keep = (evals > degen_thresh).to(torch.float32)
        xi = evecs @ (keep * (evecs.T @ xi))
    rot_n = torch.linalg.norm(xi[:3])
    trans_n = torch.linalg.norm(xi[3:])
    scale = torch.clamp(torch.minimum(
        max_rot / torch.clamp(rot_n, min=1e-9),
        max_trans / torch.clamp(trans_n, min=1e-9)), max=1.0)
    xi = xi * scale
    dq = quat_exp(xi[:3])
    new_quat = quat_normalize(quat_multiply(dq, quat))
    new_pos = quat_rotate(dq, pos) + xi[3:]
    return new_pos, new_quat


def _solve3(a, b):
    """Batched 3 × 3 solve ``a x = b`` ((N, 3, 3), (N, 3)) in the JAX
    package's arithmetic on the CPU, LAPACK's ``sgetrf`` and two
    ``strsm`` as the C library computes them: partial pivoting (the first
    largest |pivot|), multipliers by the pivot's reciprocal, the last
    trailing entry as one FMA dot, the triangular solves in its order of
    fused and plain updates and reciprocal scalings. The plane fits of the
    scan-to-map match solve nearly singular systems (five neighbours in a
    few centimetres), whose solutions move by 1e-3 between two LU
    orderings, and the matched pose by 1e-5."""
    n = a.shape[0]
    ar = torch.arange(n, device=a.device)
    c0 = torch.argmax(a[:, :, 0].abs(), dim=1)          # first pivot row
    rest = torch.stack([torch.where(c0 == 0, 1, 0),
                        torch.where(c0 == 2, 1, 2)], dim=1)
    r0 = a[ar, c0]
    inv0 = 1.0 / r0[:, 0]
    cand = a[ar[:, None], rest]                          # (N, 2, 3)
    l_c = cand[:, :, 0] * inv0[:, None]
    col1 = cand[:, :, 1] - l_c * r0[:, None, 1]
    swap = col1[:, 1].abs() > col1[:, 0].abs()
    i1 = swap.long()
    row1, row2 = cand[ar, i1], cand[ar, 1 - i1]
    l10, l20 = l_c[ar, i1], l_c[ar, 1 - i1]
    u00, u01, u02 = r0.unbind(-1)
    u11 = col1[ar, i1]
    u12 = row1[:, 2] - l10 * u02
    l21 = col1[ar, 1 - i1] * (1.0 / u11)
    u22 = row2[:, 2] - fma(l21, u12, l20 * u02)
    bp = torch.stack([b[ar, c0], b[ar, rest[ar, i1]],
                      b[ar, rest[ar, 1 - i1]]], dim=1)
    y0 = bp[:, 0]
    y1 = fma(-l10, y0, bp[:, 1])
    y2 = bp[:, 2] - fma(l21, y1, l20 * y0)
    x2 = y2 * (1.0 / u22)
    t0 = y0 - u02 * x2
    x1 = (y1 - u12 * x2) * (1.0 / u11)
    x0 = fma(-u01, x1, t0) * (1.0 / u00)
    return torch.stack([x0, x1, x2], dim=1)


def _einsum_fma(a, b):
    """(N, K, I) × (N, K, J) → (N, I, J) summed over K as an FMA chain,
    as XLA on the CPU computes ``einsum('nki,nkj->nij')``."""
    return fma_dot(a.transpose(1, 2)[:, :, None, :],
                   b.transpose(1, 2)[:, None, :, :])


def _sum5(x):
    """Σ over axis 1 in order (XLA's reduce of a short axis)."""
    acc = x[:, 0]
    for k in range(1, x.shape[1]):
        acc = acc + x[:, k]
    return acc


def _first_true(ok):
    """(N, K) bool → (first-true column index, any) per row."""
    return torch.argmax(ok.to(torch.uint8), dim=1), ok.any(dim=1)


def _take(idx, j):
    return idx.gather(1, j[:, None])[:, 0]


def _init_pose(init_pos, init_quat, device):
    if init_pos is None:
        init_pos = torch.zeros((3,), dtype=torch.float32, device=device)
    if init_quat is None:
        init_quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    return init_pos, init_quat


def _weighted_mean_abs(r0, w):
    return (r0.abs() * w).sum() / torch.clamp(w.sum(), min=1.0)


def match_scans(cfg: SlamConfig, src_sharp, src_sharp_mask, src_flat,
                src_flat_mask, tgt_less_sharp, tgt_less_sharp_mask,
                tgt_less_flat, tgt_less_flat_mask,
                init_pos=None, init_quat=None, iters: int | None = None,
                tgt_less_sharp_ring=None, tgt_less_flat_ring=None):
    """LOAM odometry: align source features to target features.

    With target ring indices, correspondences follow the reference's ring
    constraints (`featureAssociation.cpp:633-676,751-806`): a corner line
    pairs the nearest point with the nearest point on a different ring
    within ±2; a surf plane spans the nearest point, a same-ring neighbour
    and a different-ring neighbour. Without rings: plain 2-/3-NN.

    Returns (pos, quat, mean_residual): the transform taking source-frame
    points into the target frame."""
    pos, quat = _init_pose(init_pos, init_quat, src_sharp.device)
    mean_r = torch.zeros((), dtype=torch.float32, device=src_sharp.device)
    iters = iters or cfg.scan_match_iters
    max_d2 = cfg.nearest_feature_search_distance ** 2
    t_sharp = _targets(tgt_less_sharp, tgt_less_sharp_mask)
    t_flat = _targets(tgt_less_flat, tgt_less_flat_mask)
    src, ns = torch.cat([src_sharp, src_flat]), src_sharp.shape[0]
    for _ in range(iters):
        base = _apply(pos, quat, src)
        ps, pf = base[:ns], base[ns:]
        # --- corners → lines -------------------------------------------
        if tgt_less_sharp_ring is None:
            idx_c, d2_c = _knn(ps, t_sharp, 2)
            la = tgt_less_sharp[idx_c[:, 0]]
            lb = tgt_less_sharp[idx_c[:, 1]]
            w_c = (src_sharp_mask & (d2_c[:, 0] < max_d2)
                   & (d2_c[:, 1] < max_d2)).to(torch.float32)
        else:
            idx_c, d2_c = _knn(ps, t_sharp, K_NN)
            rings = tgt_less_sharp_ring[idx_c]
            r0 = rings[:, :1]
            cand = ((rings != r0) & (torch.abs(rings - r0) <= 2)
                    & (d2_c < max_d2))
            cand[:, 0] = False
            j2, has2 = _first_true(cand)
            la = tgt_less_sharp[idx_c[:, 0]]
            lb = tgt_less_sharp[_take(idx_c, j2)]
            w_c = (src_sharp_mask & (d2_c[:, 0] < max_d2) & has2
                   ).to(torch.float32)
        # --- flats → planes ---------------------------------------------
        if tgt_less_flat_ring is None:
            idx_s, d2_s = _knn(pf, t_flat, 3)
            pa = tgt_less_flat[idx_s[:, 0]]
            pb = tgt_less_flat[idx_s[:, 1]]
            pc = tgt_less_flat[idx_s[:, 2]]
            w_extra = torch.ones_like(src_flat_mask)
        else:
            idx_s, d2_s = _knn(pf, t_flat, K_NN)
            rings = tgt_less_flat_ring[idx_s]
            r0 = rings[:, :1]
            gate = d2_s < max_d2
            same = (rings == r0) & gate
            same[:, 0] = False
            diff = (rings != r0) & (torch.abs(rings - r0) <= 2) & gate
            jb, has_b = _first_true(same)
            jc, has_c = _first_true(diff)
            pa = tgt_less_flat[idx_s[:, 0]]
            pb = tgt_less_flat[_take(idx_s, jb)]
            pc = tgt_less_flat[_take(idx_s, jc)]
            w_extra = has_b & has_c
        normal = torch.linalg.cross(pb - pa, pc - pa, dim=-1)
        degenerate = torch.linalg.norm(normal, dim=-1) < 1e-6
        w_s = (src_flat_mask & (d2_s[:, 0] < max_d2) & ~degenerate
               & w_extra).to(torch.float32)
        dn, normal = _unit(lb - la), _unit(normal)

        def res(xi, base=base, la=la, dn=dn, pa=pa, normal=normal):
            p = _twist(xi, base)
            return torch.cat([_line_residuals(p[:ns], la, dn),
                              _plane_residuals(p[ns:], pa, normal)])

        w = torch.cat([w_c, w_s])
        # bisquare-style down-weighting of large residuals
        r0 = res(torch.zeros((6,), dtype=torch.float32, device=pos.device))
        w = w * torch.clamp(1.0 - 0.9 * r0.abs(), min=0.1)
        pos, quat = _gn_step(pos, quat, res, r0, w)
        mean_r = _weighted_mean_abs(r0, w)
    return pos, quat, mean_r


def icp_point2point(src, src_mask, tgt, tgt_mask, iters: int = 30,
                    max_corr_dist: float = 1.0, init_pos=None,
                    init_quat=None):
    """`OptimizedICPGN` (`optimized_ICP_GN.cpp`): Gauss-Newton
    point-to-point ICP with a max-correspondence bound.

    Returns (pos, quat, fitness): fitness = mean squared distance of
    matched points (the reference's `history_keyframe_fitness_score` gate
    reads it)."""
    pos, quat = _init_pose(init_pos, init_quat, src.device)
    fitness = torch.full((), float("inf"), device=src.device)
    targets = _targets(tgt, tgt_mask)
    for _ in range(iters):
        p = _apply(pos, quat, src)
        idx, d2 = _knn(p, targets, 1)
        q = tgt[idx[:, 0]]
        w = (src_mask & (d2[:, 0] < max_corr_dist ** 2)).to(torch.float32)

        def res(xi, p=p, q=q):
            return (_twist(xi, p) - q).reshape(-1)

        r = res(torch.zeros((6,), dtype=torch.float32, device=src.device))
        pos, quat = _gn_step(pos, quat, res, r, w.repeat_interleave(3))
        fitness = (d2[:, 0] * w).sum() / torch.clamp(w.sum(), min=1.0)
    return pos, quat, fitness


def match_to_map(cfg: SlamConfig, src_sharp, src_sharp_mask, src_flat,
                 src_flat_mask, map_sharp, map_sharp_mask, map_flat,
                 map_flat_mask, init_pos=None, init_quat=None,
                 iters: int | None = None):
    """Scan-to-map matching with the reference's 5-NN geometric fits
    (`mapOptimization.cpp:1407-1660`): corners fit a line through the 5-NN
    mean along the principal covariance eigenvector, valid when λ₁ > 3·λ₂
    and the 5th neighbour is within 1 m; surfs fit a plane by least
    squares (A·n = −1), valid when all 5 points lie within 0.2 m of it.

    Returns (pos, quat, mean_residual)."""
    pos, quat = _init_pose(init_pos, init_quat, src_sharp.device)
    mean_r = torch.zeros((), dtype=torch.float32, device=src_sharp.device)
    iters = iters or cfg.map_match_iters
    eye3 = torch.eye(3, dtype=torch.float32, device=src_sharp.device)
    t_sharp = _targets(map_sharp, map_sharp_mask)
    t_flat = _targets(map_flat, map_flat_mask)
    src, ns = torch.cat([src_sharp, src_flat]), src_sharp.shape[0]
    for _ in range(iters):
        base = _apply(pos, quat, src)
        ps, pf = base[:ns], base[ns:]
        # --- corners → eigen lines (`:1407-1500`) ----------------------
        idx_c, d2_c = _knn(ps, t_sharp, 5)
        nn_c = map_sharp[idx_c]                       # (N, 5, 3)
        mean_c = (_sum5(nn_c) * recip(5))[:, None, :]
        cen = nn_c - mean_c
        cov = _einsum_fma(cen, cen) * recip(5)
        evals, evecs = torch.linalg.eigh(cov)         # ascending
        principal = evecs[:, :, 2]
        line_ok = evals[:, 2] > 3.0 * evals[:, 1]
        la = mean_c[:, 0, :] + 0.1 * principal
        lb = mean_c[:, 0, :] - 0.1 * principal
        w_c = (src_sharp_mask & line_ok & (d2_c[:, 4] < 1.0)
               ).to(torch.float32)

        # --- surfs → lstsq planes (`:1519-1660`) ------------------------
        idx_s, d2_s = _knn(pf, t_flat, 5)
        nn_s = map_flat[idx_s]                        # (N, 5, 3)
        n_vec = _solve3(_einsum_fma(nn_s, nn_s) + f32(1e-6) * eye3[None],
                        -_sum5(nn_s))
        n_norm = fma_norm(n_vec)[:, None]
        unit_n = n_vec / torch.clamp(n_norm, min=1e-9)
        d_plane = 1.0 / torch.clamp(n_norm[:, 0], min=1e-9)
        support_d = torch.abs(fma_dot(nn_s, unit_n[:, None, :])
                              + d_plane[:, None])
        plane_ok = (support_d < 0.2).all(dim=1)
        w_s = (src_flat_mask & plane_ok & (d2_s[:, 4] < 1.0)
               ).to(torch.float32)

        dn = _unit(lb - la)

        def res(xi, base=base, la=la, dn=dn, unit_n=unit_n,
                d_plane=d_plane):
            p = _twist(xi, base)
            return torch.cat([_line_residuals(p[:ns], la, dn),
                              (p[ns:] * unit_n).sum(dim=-1) + d_plane])

        w = torch.cat([w_c, w_s])
        r0 = res(torch.zeros((6,), dtype=torch.float32, device=pos.device))
        # reference robust gate: s = 1 − 0.9·|r|, drop when s ≤ 0.1
        # (`mapOptimization.cpp:1480-1497,1643-1660`)
        s = 1.0 - 0.9 * r0.abs()
        w = w * torch.where(s > 0.1, s, 0.0)
        pos, quat = _gn_step(pos, quat, res, r0, w, degen_thresh=100.0)
        mean_r = _weighted_mean_abs(r0, w)
    return pos, quat, mean_r
