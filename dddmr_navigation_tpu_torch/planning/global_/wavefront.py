"""Wavefront shortest paths over the shared ground graph, batched over
robots.

Counterpart of ``dddmr_navigation_tpu/planning/global_/wavefront.py``
(`A_Star_on_Graph::getPath`, `a_star_on_pc.cpp:200-329`, as parallel
Bellman relaxation from the goal on the padded (G, K) neighbor table, and
greedy descent over the relaxed field). The graph and its turning tables
are shared; each robot has its own entry costs, edge validity, goal and
field.

Exactness: the relaxation and extraction are adds, mins and argmins in the
JAX version's order (`wavefront.py:150-152`, `:170-171`), so from the same
inputs they give its field and its paths bit for bit. Two rewrites keep the
values: the arrival-bin select (a min over {0, +inf}-masked bins) is a
gather of that bin, and the loop-invariant turning term w·dθ is computed
once, outside the loop.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dddmr_navigation_tpu_torch.rounding import (
    acos_xla, atan2_xla, exp_fma, fma_dot, fma_norm, recip)
from dddmr_navigation_tpu_torch.ops.fixpoint import iterate_to_fixpoint
from dddmr_navigation_tpu_torch.ops.walk import walk_table


class WavefrontResult(NamedTuple):
    dist: torch.Tensor        # (B, G) cost-to-goal
    reachable: torch.Tensor   # (B, G) bool
    iters: torch.Tensor       # (B,) int32 iterations run


def node_costs(dgraph, node_weight, *, inscribed_radius,
               inflation_descending_rate):
    """Cost of entering each node: the dGraph inflation factor plus the
    static node weight, +inf where lethal (dGraph < inscribed)
    (`a_star_on_pc.cpp:263-288`). dgraph (B, G), node_weight (G,). The exp
    rounds as the JAX version's (:func:`rounding.exp_fma`): an ulp of an
    entry cost can break a tie between equal-cost routes, and the warm
    relaxation then runs other iterations than the JAX package's."""
    factor = exp_fma(-inflation_descending_rate * (dgraph - inscribed_radius))
    cost = factor + node_weight
    return torch.where(dgraph < inscribed_radius, torch.inf, cost)


def edge_azimuth(positions, nbr_idx):
    """(G, K) XY azimuth of each edge u→v, with XLA's atan2
    (``rounding.atan2_xla``). Map geometry: built once."""
    safe = torch.clamp(nbr_idx, min=0).long()
    d = positions[safe] - positions[:, None, :]
    return atan2_xla(d[..., 1], d[..., 0])


def edge_bins(az, n_dir_bins: int, jit: bool = False):
    """floor((az + π) / 2π · B) mod B, the JAX package's eager rounding
    (a true division); ``jit=True`` rounds as its jitted planner does,
    which computes the bins inside the program (a multiply by the f32
    reciprocal of 2π)."""
    if jit:
        frac = (az + math.pi) * recip(2.0 * math.pi)
    else:
        frac = (az + math.pi) / (2.0 * math.pi)
    return torch.remainder(torch.floor(frac * n_dir_bins).int(), n_dir_bins)


def _wrap_angle(a):
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def _theta_capped(theta_abs):
    """The reference's ≤0.345 rad dead zone (`a_star_on_pc.cpp:163-164`)."""
    return torch.where(theta_abs <= 0.345, 0.0, theta_abs)


def theta_reference(p_parent, p_cur, p_exp, jit: bool = False):
    """`getThetaFromParent2Expanding` (`a_star_on_pc.cpp:142-166`), quirks
    included: zero for vanishing XY vectors, zero when the |x| components
    agree within 1e-4, dead zone ≤ 0.345 rad. Rounded as the JAX package
    builds its turning table, op by op: the dot's products round before
    their sum, while ``jnp.linalg.norm`` is one compiled call (an FMA
    chain), and the arccos is XLA's (``rounding.acos_xla``); ``jit=True``
    makes the dot an FMA chain too, as in the jitted planner, which builds
    the table inside the program."""
    v1 = (p_cur - p_parent)[..., :2]
    v2 = (p_exp - p_cur)[..., :2]
    n1 = fma_norm(v1)
    n2 = fma_norm(v2)
    dot = fma_dot(v1, v2) if jit else torch.sum(v1 * v2, dim=-1)
    cos_t = dot / torch.clamp(n1 * n2, min=1e-12)
    theta = acos_xla(torch.clamp(cos_t, -1.0, 1.0))
    zero = ((n1 == 0.0) | (n2 == 0.0)
            | (torch.abs(torch.abs(v1[..., 0]) - torch.abs(v2[..., 0])) <= 1e-4))
    return _theta_capped(torch.where(zero, 0.0, theta))


def turning_penalty_table(nbr_idx, positions, turning_weight: float,
                          jit: bool = False):
    """(G, K, K) w_turn·θ for every (arrival edge u→v, out-edge v→w) pair,
    exact reference θ from the actual parent. Map geometry: built once.
    ``jit`` as in :func:`theta_reference`."""
    safe = torch.clamp(nbr_idx, min=0).long()
    pos_u = positions[:, None, None, :]
    pos_v = positions[safe][:, :, None, :]
    pos_w = positions[safe][safe]
    return turning_weight * theta_reference(pos_u, pos_v, pos_w, jit)


def _goal_mask(goal_idx, g):
    return torch.arange(g, device=goal_idx.device) == goal_idx[:, None]


def wavefront_distances_turning(nbr_idx, nbr_dist, nbr_valid, enter_cost,
                                avg_intensity, goal_idx, positions,
                                turning_weight: float, *,
                                n_dir_bins: int = 16, max_iters: int = 512,
                                dist0=None, az=None, bin_of_edge=None):
    """Direction-expanded relaxation for ``turning_weight > 0``: the state
    is (node, incoming-direction bin), so the parent-angle term
    (`a_star_on_pc.cpp:284-288`) is carried inside the relaxation. The
    plain Bellman operator with the goal pinned at 0, warm-started from
    ``dist0`` when given.

    Args:
      nbr_idx, nbr_dist: (G, K) shared table; nbr_valid: (B, G, K).
      enter_cost: (B, G); avg_intensity: (G,); goal_idx: (B,).
      dist0: optional (B, G, n_dir_bins) warm field.

    Returns (dist (B, G, n_dir_bins), edge bins (G, K), iters (B,)).
    """
    g, k = nbr_idx.shape
    b = enter_cost.shape[0]
    nb = n_dir_bins
    if az is None:
        az = edge_azimuth(positions, nbr_idx)
    if bin_of_edge is None:
        bin_of_edge = edge_bins(az, nb)
    centers = -math.pi + (torch.arange(nb, dtype=torch.float32,
                                       device=az.device) + 0.5) \
        * (2.0 * math.pi / nb)
    turn = turning_weight * _theta_capped(
        torch.abs(_wrap_angle(az[:, :, None] - centers)))        # (G, K, nb)

    safe = torch.clamp(nbr_idx, min=0).long()
    goal = _goal_mask(goal_idx, g)[:, :, None]                   # (B, G, 1)
    if dist0 is None:
        dist0 = torch.full((b, g, nb), torch.inf, device=enter_cost.device)
    dist0 = torch.where(goal, 0.0, dist0)
    enter_g = enter_cost[:, safe]                                # (B, G, K)
    # the arrival bin of each edge's far end, as a flat (G·nb) index
    arrive = (safe * nb + bin_of_edge.long()).view(1, -1).expand(b, -1)

    def relax(dist):
        nd_in = dist.reshape(b, g * nb).gather(1, arrive).view(b, g, k)
        base = nd_in + nbr_dist + enter_g + avg_intensity[:, None]
        base = torch.where(nbr_valid, base, torch.inf)
        cand = base[..., None] + turn                            # (B,G,K,nb)
        return torch.where(goal, 0.0, cand.amin(dim=2))

    dist, iters = iterate_to_fixpoint(relax, dist0, max_iters)
    return dist, bin_of_edge, iters


def wavefront_distances(nbr_idx, nbr_dist, nbr_valid, enter_cost,
                        avg_intensity, goal_idx, *, max_iters: int = 512,
                        dist0=None) -> WavefrontResult:
    """Cost-to-goal of every node, ``dist[u] = min_v dist[v] + step_uv +
    enter_cost[v] + avg_intensity[u]`` (`a_star_on_pc.cpp:288`), warm-started
    from ``dist0`` (B, G) when given."""
    g = nbr_idx.shape[0]
    b = enter_cost.shape[0]
    safe = torch.clamp(nbr_idx, min=0).long()
    goal = _goal_mask(goal_idx, g)
    if dist0 is None:
        dist0 = torch.full((b, g), torch.inf, device=enter_cost.device)
    dist0 = torch.where(goal, 0.0, dist0)
    enter_g = enter_cost[:, safe]

    def relax(dist):
        cand = dist[:, safe] + nbr_dist + enter_g + avg_intensity[:, None]
        cand = torch.where(nbr_valid, cand, torch.inf)
        return torch.where(goal, 0.0, cand.amin(dim=2))

    dist, iters = iterate_to_fixpoint(relax, dist0, max_iters)
    return WavefrontResult(dist=dist, reachable=torch.isfinite(dist),
                           iters=iters)


def extract_path_turning(nbr_idx, nbr_dist, nbr_valid, enter_cost, dist_gb,
                         bin_of_edge, start_idx, goal_idx, positions,
                         turning_weight: float, *, max_len: int = 512,
                         turn_pen=None):
    """Greedy descent over the direction-expanded field, each hop scored
    with the exact reference turning angle from the actual parent, through
    a successor table over the (G·K) edge states.

    Returns (idxs (B, L), valid (B, L), length (B,), ok (B,))."""
    g, k = nbr_idx.shape
    b, _, nb = dist_gb.shape
    safe = torch.clamp(nbr_idx, min=0).long()
    arrive = (safe * nb + bin_of_edge.long()).view(1, -1).expand(b, -1)
    nd_in = dist_gb.reshape(b, g * nb).gather(1, arrive).view(b, g, k)
    score_next = nd_in + nbr_dist + enter_cost[:, safe]
    score_next = torch.where(nbr_valid, score_next, torch.inf)   # (B, G, K)

    if turn_pen is None:
        turn_pen = turning_penalty_table(nbr_idx, positions, turning_weight)
    cand = score_next[:, safe] + turn_pen                        # (B,G,K,K)
    kbest = torch.argmin(cand, dim=3)
    succ_edge = (safe * k + kbest).view(b, -1)
    edge_stuck = (~torch.isfinite(cand.amin(dim=3))).view(b, -1)
    edge_dst = safe.view(-1)

    # First hop: θ = 0 from the start (the n1 == 0 quirk).
    rows = torch.arange(b, device=dist_gb.device)
    cand0 = score_next[rows, start_idx]                          # (B, K)
    e0 = start_idx * k + torch.argmin(cand0, dim=1)
    stuck0 = ~torch.isfinite(cand0.amin(dim=1))

    idxs, valids, length, final = walk_table(
        succ_edge, edge_stuck, e0, stuck0, edge_dst, start_idx, goal_idx,
        max_len)
    ok = torch.isfinite(dist_gb[rows, start_idx].amin(dim=1)) \
        & (final == goal_idx)
    return idxs, valids, length, ok


def extract_path(nbr_idx, nbr_dist, nbr_valid, enter_cost, dist, start_idx,
                 goal_idx, *, max_len: int = 512):
    """Greedy descent start → goal over a plain (B, G) field, through the
    node successor table (the JAX version's table path,
    `wavefront.py:697-714`). Returns (idxs, valid, length, ok)."""
    g = nbr_idx.shape[0]
    safe = torch.clamp(nbr_idx, min=0).long()
    cand = torch.where(nbr_valid,
                       dist[:, safe] + nbr_dist + enter_cost[:, safe],
                       torch.inf)                                # (B, G, K)
    kbest = torch.argmin(cand, dim=2)
    succ = safe.expand(cand.shape[0], -1, -1).gather(2, kbest[..., None])[..., 0]
    node_stuck = ~torch.isfinite(cand.amin(dim=2))
    start = start_idx[:, None]
    idxs, valids, length, final = walk_table(
        succ, node_stuck, succ.gather(1, start)[:, 0],
        node_stuck.gather(1, start)[:, 0],
        torch.arange(g, device=dist.device), start_idx, goal_idx, max_len)
    ok = torch.isfinite(dist.gather(1, start)[:, 0]) & (final == goal_idx)
    return idxs, valids, length, ok


# ---------------------------------------------------------------------------
# the fleet's relaxations and extractions (`wavefront.py:253-380`, `:502-640`)
# ---------------------------------------------------------------------------

def fleet_wavefront_distances_turning(nbr_idx, nbr_dist, nbr_valid_r,
                                      enter_cost_r, avg_intensity,
                                      goal_idx_r, turning_weight: float, *,
                                      az, bin_of_edge, n_dir_bins: int = 16,
                                      max_iters: int = 512, dist0_r=None):
    """The direction-expanded relaxation of a fleet sharing one graph,
    with one iteration count for all robots.

    The JAX package lays the fleet's fields out node-major so that one
    gather fetches every robot's bins (a TPU gather-count saving); the
    update is the per-robot Bellman operator element for element, which is
    :func:`wavefront_distances_turning`'s, so the fields are its fields.
    The joint loop runs until no robot changes, so its count is the
    largest per-robot count (a converged robot is a fixpoint of the
    operator). Args as there, per robot (R, ...). Returns (dist (R, G, B),
    iters () int32)."""
    dist, _, iters = wavefront_distances_turning(
        nbr_idx, nbr_dist, nbr_valid_r, enter_cost_r, avg_intensity,
        goal_idx_r, None, turning_weight, n_dir_bins=n_dir_bins,
        max_iters=max_iters, dist0=dist0_r, az=az, bin_of_edge=bin_of_edge)
    return dist, iters.amax()


def fleet_wavefront_distances(nbr_idx, nbr_dist, nbr_valid_r, enter_cost_r,
                              avg_intensity, goal_idx_r, *,
                              max_iters: int = 512, dist0_r=None):
    """The plain (turning_weight == 0) relaxation of a fleet sharing one
    graph, as the JAX package writes it: relaxing the potential
    F = dist + enter, so that the entry cost is a per-node constant added
    after the min, then one exact dist-space pass (finite dist at lethal
    nodes included). Its rounding differs from
    :func:`wavefront_distances`'. Per robot (R, ...); returns (dist (R, G),
    iters () int32)."""
    g = nbr_idx.shape[0]
    safe = torch.clamp(nbr_idx, min=0).long()
    goal = _goal_mask(goal_idx_r, g)                             # (R, G)
    dist0 = (torch.full_like(enter_cost_r, torch.inf) if dist0_r is None
             else dist0_r)
    dist0 = torch.where(goal, 0.0, dist0)
    c_node = enter_cost_r + avg_intensity
    f0 = torch.where(goal, enter_cost_r, dist0 + enter_cost_r)

    def relax(f):
        cand = torch.where(nbr_valid_r, f[:, safe] + nbr_dist, torch.inf)
        return torch.where(goal, enter_cost_r, cand.amin(dim=2) + c_node)

    f, iters = iterate_to_fixpoint(relax, f0, max_iters)
    cand = torch.where(nbr_valid_r,
                       f[:, safe] + nbr_dist + avg_intensity[:, None],
                       torch.inf)
    return torch.where(goal, 0.0, cand.amin(dim=2)), iters.amax()


def fleet_extract_path_turning(nbr_idx, nbr_dist, nbr_valid_r, enter_cost_r,
                               dist_r, bin_of_edge, start_idx_r, goal_idx_r,
                               turn_pen, *, max_len: int = 512):
    """The fleet's successor-table extraction over direction-expanded
    fields. The JAX package's node-major layout is a TPU gather layout;
    the candidates, argmins and walk are :func:`extract_path_turning`'s,
    element for element. Returns (idxs (R, L), valids (R, L), length (R,),
    ok (R,))."""
    return extract_path_turning(
        nbr_idx, nbr_dist, nbr_valid_r, enter_cost_r, dist_r, bin_of_edge,
        start_idx_r, goal_idx_r, None, 0.0, max_len=max_len,
        turn_pen=turn_pen)


def fleet_extract_path(nbr_idx, nbr_dist, nbr_valid_r, enter_cost_r, dist_r,
                       start_idx_r, goal_idx_r, *, max_len: int = 512):
    """The fleet's node-table extraction over plain (R, G) fields:
    :func:`extract_path`'s candidates and walk, element for element."""
    return extract_path(nbr_idx, nbr_dist, nbr_valid_r, enter_cost_r, dist_r,
                        start_idx_r, goal_idx_r, max_len=max_len)
