"""Pose-graph optimization, the counterpart of
``dddmr_navigation_tpu/slam/pose_graph.py`` (the stand-in for lego_loam's
GTSAM iSAM2 back end, `mapOptimization.cpp:1781-2028`: odometry factors,
loop-closure edges, `addEdgeFromPose` `:1162-1177`, `correctPoses`
`:1990`).

The graph is padded to (max_keyframes, max_edges) tensors and optimized by
dense batch Gauss-Newton:

  * residual per edge (i → j, measurement Z): the se3 log of
    Z⁻¹·(Tᵢ⁻¹·Tⱼ), 6 numbers (rotvec, translation);
  * the Jacobian with respect to all pose twists by forward mode at ξ = 0
    (``torch.func.jacfwd``, as ``jax.jacfwd``), each edge's block over its
    two nodes' tangents placed in the dense J: at K = 256 and 512 edges J
    is 3,072 × 1,536;
  * the 6K × 6K normal system with a 1e-5 ridge, solved by ``solve_ex``
    (no host read of LAPACK's ``info``); node 0 is anchored and padded
    nodes frozen by zeroing their columns.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from dddmr_navigation_tpu_torch.rounding import fma_dot
from dddmr_navigation_tpu_torch.geometry import (
    quat_conjugate, quat_exp, quat_multiply_fma, quat_normalize,
    quat_rotate_fma)


class PoseGraphArrays(NamedTuple):
    """Padded pose graph (device tensors)."""
    pos: torch.Tensor        # (K, 3)
    quat: torch.Tensor       # (K, 4)
    node_mask: torch.Tensor  # (K,) bool
    edge_i: torch.Tensor     # (E,) i32 from-node
    edge_j: torch.Tensor     # (E,) i32 to-node
    edge_pos: torch.Tensor   # (E, 3) measured Tᵢ⁻¹·Tⱼ translation
    edge_quat: torch.Tensor  # (E, 4) measured rotation
    edge_weight: torch.Tensor  # (E,) f32 information scale (0 = padding)


def empty_graph(max_keyframes: int, max_edges: int,
                device="cuda") -> PoseGraphArrays:
    idq = torch.tensor([0.0, 0.0, 0.0, 1.0], device=device)
    return PoseGraphArrays(
        pos=torch.zeros((max_keyframes, 3), device=device),
        quat=idq.expand(max_keyframes, 4).clone(),
        node_mask=torch.zeros((max_keyframes,), dtype=torch.bool,
                              device=device),
        edge_i=torch.zeros((max_edges,), dtype=torch.int32, device=device),
        edge_j=torch.zeros((max_edges,), dtype=torch.int32, device=device),
        edge_pos=torch.zeros((max_edges, 3), device=device),
        edge_quat=idq.expand(max_edges, 4).clone(),
        edge_weight=torch.zeros((max_edges,), device=device))


def _quat_log(q):
    """quat → rotvec (3,), batched; atan2-based, so the derivative is
    well defined at the identity (jacfwd evaluates at ξ = 0)."""
    qn = quat_normalize(q)
    sign = torch.where(qn[..., 3] < 0, -1.0, 1.0)
    vn = torch.sqrt(fma_dot(qn[..., :3], qn[..., :3]) + 1e-16)
    ang = 2.0 * torch.atan2(vn, torch.abs(qn[..., 3]))
    return sign[..., None] * qn[..., :3] * (ang / vn)[..., None]


def _retract(pos, quat, xi):
    """Right-perturbation retraction per node: T·exp(ξ)."""
    dq = quat_exp(xi[..., :3])
    new_quat = quat_normalize(quat_multiply_fma(quat, dq))
    new_pos = pos + quat_rotate_fma(quat, xi[..., 3:])
    return new_pos, new_quat


def _edge_residual(xi_i, xi_j, pi, qi, pj, qj, z_pos, z_quat):
    """One edge's (6,) residual at tangent offsets ξᵢ, ξⱼ (6,): the log of
    Z⁻¹·(Tᵢ⁻¹·Tⱼ) after retracting both nodes."""
    pi, qi = _retract(pi, qi, xi_i)
    pj, qj = _retract(pj, qj, xi_j)
    qi_inv = quat_conjugate(qi)
    rel_q = quat_multiply_fma(qi_inv, qj)
    rel_p = quat_rotate_fma(qi_inv, pj - pi)
    zq_inv = quat_conjugate(z_quat)
    err_q = quat_multiply_fma(zq_inv, rel_q)
    err_p = quat_rotate_fma(zq_inv, rel_p - z_pos)
    return torch.cat([_quat_log(err_q), err_p], dim=-1)


def _edge_system(g: PoseGraphArrays):
    """The weighted residual vector (6E,) and its dense Jacobian
    (6E, 6K) at ξ = 0. One ``jacfwd`` over a 12-vector ζ that offsets
    every edge's two nodes alike (ξᵢ = ζ[:6], ξⱼ = ζ[6:]) gives each
    edge's 6 × 12 block, since an edge's residual reads only its own two
    nodes; the blocks land in the nodes' columns. These are the entries of
    the JAX package's ``jacfwd`` over the whole (K, 6) tangent, whose other
    columns are zero, at 12 forward passes instead of 6K."""
    k, e = g.pos.shape[0], g.edge_i.shape[0]
    ei, ej = g.edge_i.long(), g.edge_j.long()
    args = (g.pos[ei], g.quat[ei], g.pos[ej], g.quat[ej], g.edge_pos,
            g.edge_quat)

    def r(z):
        return _edge_residual(z[:6].expand(e, 6), z[6:].expand(e, 6), *args)
    z0 = torch.zeros((12,), dtype=torch.float32, device=g.pos.device)
    w = g.edge_weight[:, None]
    jac = jacfwd(r)(z0).float() * w[:, :, None]        # (E, 6, 12)
    J = torch.zeros((e, k, 6, 6), dtype=torch.float32, device=g.pos.device)
    rows = torch.arange(e, device=g.pos.device)
    J.index_put_((rows, ei), jac[:, :, :6], accumulate=True)
    J.index_put_((rows, ej), jac[:, :, 6:], accumulate=True)
    return ((r(z0) * w).reshape(-1),
            J.permute(0, 2, 1, 3).reshape(6 * e, 6 * k))


def optimize_pose_graph(g: PoseGraphArrays, iters: int = 8
                        ) -> PoseGraphArrays:
    """Batch Gauss-Newton over all poses; pose 0 anchored."""
    k = g.pos.shape[0]
    dev = g.pos.device
    free = (g.node_mask & (torch.arange(k, device=dev) > 0)).to(
        torch.float32)
    colmask = free.repeat_interleave(6)
    ridge = 1e-5 * torch.eye(6 * k, dtype=torch.float32, device=dev)
    for _ in range(iters):
        rv, J = _edge_system(g)
        J = J * colmask[None, :]
        JtJ = J.T @ J + ridge
        step = -torch.linalg.solve_ex(JtJ, J.T @ rv)[0] * colmask
        pos, quat = _retract(g.pos, g.quat, step.reshape(k, 6))
        g = g._replace(pos=pos, quat=quat)
    return g


def _f32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def add_node(g: PoseGraphArrays, idx: int, pos, quat) -> PoseGraphArrays:
    p, q, m = g.pos.clone(), g.quat.clone(), g.node_mask.clone()
    p[idx] = _f32(pos, p.device)
    q[idx] = _f32(quat, q.device)
    m[idx] = True
    return g._replace(pos=p, quat=q, node_mask=m)


def add_edge(g: PoseGraphArrays, eidx: int, i: int, j: int, rel_pos,
             rel_quat, weight=1.0) -> PoseGraphArrays:
    """`addEdgeFromPose` — the reference scales noise by the ICP score;
    pass weight = 1/score for the same effect."""
    out = {f: getattr(g, f).clone() for f in
           ("edge_i", "edge_j", "edge_pos", "edge_quat", "edge_weight")}
    out["edge_i"][eidx] = i
    out["edge_j"][eidx] = j
    out["edge_pos"][eidx] = _f32(rel_pos, g.edge_pos.device)
    out["edge_quat"][eidx] = _f32(rel_quat, g.edge_pos.device)
    out["edge_weight"][eidx] = weight
    return g._replace(**out)


def detect_loop_candidate(g: PoseGraphArrays, cur_idx: int,
                          search_radius: float, min_index_gap: int = 20):
    """`detectLoopClosure` (`mapOptimization.cpp:886-960`): the nearest
    historic keyframe within ``search_radius`` of the current one, at
    least ``min_index_gap`` keyframes old. Returns (idx, found) as device
    scalars."""
    cur = g.pos[cur_idx]
    d = torch.linalg.norm(g.pos - cur[None, :], dim=-1)
    k = g.pos.shape[0]
    old = (torch.arange(k, device=g.pos.device) < cur_idx - min_index_gap) \
        & g.node_mask
    d = torch.where(old, d, float("inf"))
    i = torch.argmin(d)
    return i, d[i] <= search_radius
