"""Global planner: goal snapping, wavefront solve and extraction, batched
over robots on one shared graph.

Counterpart of ``dddmr_navigation_tpu/planning/global_/planner.py``
(`GlobalPlanner::makeROSPlan`, `global_planner.cpp:512-544`,
`getStartGoalID`, `:393-473`, and `getROSPath`, `:313-391`);
``post_smooth_path`` is the JAX package's host numpy function, copied.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dddmr_navigation_tpu_torch.config import GlobalPlannerConfig
from dddmr_navigation_tpu_torch.geometry import slope_aware_quat
from dddmr_navigation_tpu_torch.rounding import fma_norm
from dddmr_navigation_tpu_torch.planning.global_.los import (
    long_edge_counts, long_edge_los_mask)
from dddmr_navigation_tpu_torch.planning.global_.wavefront import (
    node_costs, wavefront_distances, extract_path,
    wavefront_distances_turning, extract_path_turning)
from dddmr_navigation_tpu_torch.runtime import tracing


class GlobalPathResult(NamedTuple):
    node_ids: torch.Tensor      # (B, max_path_len)
    node_valid: torch.Tensor    # (B, max_path_len) bool
    length: torch.Tensor        # (B,)
    ok: torch.Tensor            # (B,) bool
    dist_to_goal: torch.Tensor  # (B, G) the reusable distance field
    dist_carry: torch.Tensor    # raw field, (B, G) or (B, G, bins), for warm starts
    goal_idx: torch.Tensor      # (B,) snapped goal node (warm-start key)
    iters: torch.Tensor         # (B,) int32 relaxation iterations run


def snap_to_ground(ground, ground_valid, pos, radius: float = 0.5):
    """Nearest ground node within ``radius`` of each pos (B, 3)
    (`getStartGoalID`). Returns (index (B,), ok (B,))."""
    d = fma_norm(ground - pos[:, None, :])
    d = torch.where(ground_valid, d, torch.inf)
    i = torch.argmin(d, dim=1)
    return i, d.gather(1, i[:, None])[:, 0] <= radius


class PlanPrep(NamedTuple):
    """Per-robot pre-relaxation state (`plan_prepare` → relax →
    `plan_finish`)."""
    start_idx: torch.Tensor    # (B,)
    goal_idx: torch.Tensor     # (B,)
    sg_ok: torch.Tensor        # (B,) both snaps succeeded
    graph_valid: torch.Tensor  # (B, G, K) after the LOS gate
    enter: torch.Tensor        # (B, G) node entry costs (inf = lethal)
    warm_dist: object          # warm field or None


def plan_prepare(cfg: GlobalPlannerConfig, graph_idx, graph_dist, graph_valid,
                 ground, ground_valid, dgraph, node_weight,
                 start_pos, goal_pos, *, inscribed_radius: float,
                 inflation_descending_rate: float,
                 lethal_pts=None, lethal_valid=None,
                 warm_dist=None, warm_goal_idx=None) -> PlanPrep:
    """Snap start and goal, LOS-gate long edges, compute entry costs, and
    drop the warm field of a robot whose snapped goal changed."""
    b = dgraph.shape[0]
    start_idx, s_ok = snap_to_ground(ground, ground_valid, start_pos)
    goal_idx, g_ok = snap_to_ground(ground, ground_valid, goal_pos)

    if warm_dist is not None and warm_goal_idx is not None:
        same = (goal_idx == warm_goal_idx).view(
            (b,) + (1,) * (warm_dist.dim() - 1))
        warm_dist = torch.where(same, warm_dist, torch.inf)

    graph_valid = graph_valid.expand(b, *graph_idx.shape)
    if lethal_pts is not None and cfg.max_long_edges > 0:
        with tracing.child("plan.los"):
            if tracing.on():
                seen, kept = long_edge_counts(
                    graph_dist, graph_valid, inscribed_radius=inscribed_radius,
                    max_long_edges=cfg.max_long_edges)
                tracing.count_device("los_edges_seen", seen.sum())
                tracing.count_device("los_edges_kept", kept.sum())
            graph_valid = graph_valid & long_edge_los_mask(
                graph_idx, graph_dist, graph_valid, ground, lethal_pts,
                lethal_valid, inscribed_radius=inscribed_radius,
                max_long_edges=cfg.max_long_edges, samples=cfg.los_samples)

    enter = node_costs(dgraph, node_weight,
                       inscribed_radius=inscribed_radius,
                       inflation_descending_rate=inflation_descending_rate)
    return PlanPrep(start_idx=start_idx, goal_idx=goal_idx, sg_ok=s_ok & g_ok,
                    graph_valid=graph_valid, enter=enter, warm_dist=warm_dist)


def relax(cfg: GlobalPlannerConfig, graph_idx, graph_dist, avg_intensity,
          ground, prep: PlanPrep, max_iters: int, az=None, bins=None):
    """The wavefront relaxation ``plan_on_graph`` runs between
    :func:`plan_prepare` and :func:`plan_finish`. Returns (field, edge bins
    or None, iters (B,))."""
    if cfg.turning_weight > 0.0:
        return wavefront_distances_turning(
            graph_idx, graph_dist, prep.graph_valid, prep.enter,
            avg_intensity, prep.goal_idx, ground, cfg.turning_weight,
            n_dir_bins=cfg.turning_dir_bins, max_iters=max_iters,
            dist0=prep.warm_dist, az=az, bin_of_edge=bins)
    wf = wavefront_distances(graph_idx, graph_dist, prep.graph_valid,
                             prep.enter, avg_intensity, prep.goal_idx,
                             max_iters=max_iters, dist0=prep.warm_dist)
    return wf.dist, None, wf.iters


def plan_finish(cfg: GlobalPlannerConfig, graph_idx, graph_dist, ground,
                prep: PlanPrep, dist_relaxed, iters, *,
                turn_pen=None, wf_bins=None,
                stall_reset=None) -> GlobalPathResult:
    """Extraction and result assembly after the relaxation. A robot whose
    relaxation reached ``max_relax_iters`` did not converge: its carried
    field is reset to +inf, so the next tick pays one cold solve."""
    if cfg.turning_weight > 0.0:
        ids, valid, length, p_ok = extract_path_turning(
            graph_idx, graph_dist, prep.graph_valid, prep.enter,
            dist_relaxed, wf_bins, prep.start_idx, prep.goal_idx, ground,
            cfg.turning_weight, max_len=cfg.max_path_len, turn_pen=turn_pen)
        dist_to_goal = dist_relaxed.amin(dim=2)
    else:
        ids, valid, length, p_ok = extract_path(
            graph_idx, graph_dist, prep.graph_valid, prep.enter,
            dist_relaxed, prep.start_idx, prep.goal_idx,
            max_len=cfg.max_path_len)
        dist_to_goal = dist_relaxed
    ok = prep.sg_ok & p_ok
    if stall_reset is None:
        stall_reset = iters >= cfg.max_relax_iters
    expand = (slice(None),) + (None,) * (dist_relaxed.dim() - 1)
    dist_carry = torch.where(stall_reset[expand], torch.inf, dist_relaxed)
    return GlobalPathResult(node_ids=ids, node_valid=valid & ok[:, None],
                            length=torch.where(ok, length, 0), ok=ok,
                            dist_to_goal=dist_to_goal, dist_carry=dist_carry,
                            goal_idx=prep.goal_idx, iters=iters)


def plan_on_graph(cfg: GlobalPlannerConfig, graph_idx, graph_dist, graph_valid,
                  ground, ground_valid, dgraph, node_weight, avg_intensity,
                  start_pos, goal_pos, *, inscribed_radius: float,
                  inflation_descending_rate: float,
                  lethal_pts=None, lethal_valid=None,
                  warm_dist=None, warm_goal_idx=None,
                  turn_pen=None, wf_az=None, wf_bins=None) -> GlobalPathResult:
    """Snap → relax → extract for every robot. ``cfg.max_long_edges == 0``
    skips the LOS stage."""
    prep = plan_prepare(
        cfg, graph_idx, graph_dist, graph_valid, ground, ground_valid,
        dgraph, node_weight, start_pos, goal_pos,
        inscribed_radius=inscribed_radius,
        inflation_descending_rate=inflation_descending_rate,
        lethal_pts=lethal_pts, lethal_valid=lethal_valid,
        warm_dist=warm_dist, warm_goal_idx=warm_goal_idx)
    dist, bins, iters = relax(cfg, graph_idx, graph_dist, avg_intensity,
                              ground, prep, cfg.max_relax_iters, wf_az,
                              wf_bins)
    return plan_finish(cfg, graph_idx, graph_dist, ground, prep, dist, iters,
                       turn_pen=turn_pen, wf_bins=bins)


def fleet_plan_finish(cfg: GlobalPlannerConfig, graph_idx, graph_dist,
                      ground, prep_r: PlanPrep, dist_r, iters, *,
                      turn_pen=None, wf_bins=None,
                      stall_reset=None) -> GlobalPathResult:
    """:func:`plan_finish` after a fleet relaxation, whose one iteration
    count ``iters`` (a () tensor) every robot reports and whose carry reset
    (a stall at ``max_relax_iters``) then holds for every robot."""
    b = prep_r.start_idx.shape[0]
    iters_r = iters.expand(b)
    if stall_reset is None:
        stall_reset = iters_r >= cfg.max_relax_iters
    return plan_finish(cfg, graph_idx, graph_dist, ground, prep_r, dist_r,
                       iters_r, turn_pen=turn_pen, wf_bins=wf_bins,
                       stall_reset=stall_reset)


_STEPS = np.arange(0.05, 0.99, 0.05, dtype=np.float32)


def _sdot_norm(d):
    """‖d‖ over the last axis of f32 rows as ``np.linalg.norm`` of one f32
    row computes it (BLAS sdot: f32 products summed in f64, rounded to f32,
    then an f32 square root)."""
    p = (d * d).astype(np.float64)
    return np.sqrt(p.sum(axis=-1).astype(np.float32))


def path_to_poses(cfg: GlobalPlannerConfig, ground: np.ndarray,
                  result: GlobalPathResult):
    """`getROSPath` (`global_planner.cpp:313-391`) of a one-robot result:
    node path → poses with slope-aware orientations, each segment
    interpolated at 0.05 fractional steps and a candidate emitted whenever
    it moved more than 0.1 m from the last emitted pose. Host numpy in f32,
    as the JAX package's ``path_to_poses``, with the steps of all segments
    taken together; the orientations come from one :func:`slope_aware_quat`
    call on the CPU.

    Returns (positions (M, 3) f32, quats (M, 4) f32)."""
    ids = result.node_ids[0][result.node_valid[0]].cpu().numpy()
    ground = np.asarray(ground, np.float32)
    if len(ids) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 4), np.float32)
    pts = ground[ids]
    nxt = np.concatenate([pts[1:], pts[-1:]])
    v = nxt - pts
    quats = slope_aware_quat(torch.from_numpy(v)).numpy()
    n_seg = len(pts) - 1
    p, vs = pts[:n_seg], v[:n_seg]
    last = p
    emit, cand = [], []
    for step in _STEPS:
        c = p + vs * step
        e = _sdot_norm(c - last) > np.float32(0.1)
        last = np.where(e[:, None], c, last)
        emit.append(e)
        cand.append(c)
    # per segment: its start, then its emitted candidates in step order
    emit_all = np.concatenate([np.ones((n_seg, 1), bool),
                               np.stack(emit, 1)], 1)
    pos_all = np.concatenate([p[:, None], np.stack(cand, 1)], 1)
    e = emit_all.shape[1]
    positions = np.concatenate([pos_all[emit_all], pts[-1:]])
    quat_rows = np.concatenate([
        np.broadcast_to(quats[:n_seg, None], (n_seg, e, 4))[emit_all],
        quats[-1:]])
    return positions.astype(np.float32), quat_rows.astype(np.float32)


def post_smooth_path(ground: np.ndarray, map_pts: np.ndarray, path_ids,
                     inscribed_radius: float = 0.5):
    """`GlobalPlanner::postSmoothPath` (`global_planner.cpp:233-311`):
    greedy line-of-sight shortcutting over the node path. A node is kept
    when any 5%-step interpolated sample along the anchor→node segment
    (a) has >1 map point within inscribed_radius (obstacle in the way),
    (b) has <2 ground points within 1.0 m (segment leaves the ground),
    (c) jumps vertically (planar reach >0.5 m with slope angle >0.349 rad),
    or (d) exceeds 20 m planar reach; otherwise the node is skipped.
    Host-side (plan post-processing, replan-rate work, like the reference's
    unused-but-shipped implementation).

    Returns the smoothed node-id list (first and last always kept).
    """
    ids = [int(i) for i in np.asarray(path_ids).ravel()]
    if len(ids) <= 2:
        return list(ids)
    ground = np.asarray(ground, np.float32)
    map_pts = np.asarray(map_pts, np.float32).reshape(-1, 3)
    out = [ids[0]]
    anchor = ground[ids[0]]
    steps = np.arange(0.05, 0.99, 0.05, dtype=np.float32)
    for nid in ids[1:-1]:
        nxt = ground[nid]
        v = nxt - anchor
        cand = anchor[None, :] + steps[:, None] * v[None, :]   # (T,3)
        keep = False
        # (a) obstacle: strictly more than one map point in radius
        if len(map_pts):
            d2 = np.sum((cand[:, None, :] - map_pts[None, :, :]) ** 2, -1)
            hits = np.sum(d2 <= inscribed_radius ** 2, axis=1)
            keep |= bool(np.any(hits > 1))
        # (b) off-ground: fewer than 2 ground points within 1 m
        d2g = np.sum((cand[:, None, :] - ground[None, :, :]) ** 2, -1)
        near_g = np.sum(d2g <= 1.0, axis=1)
        keep |= bool(np.any(near_g < 2))
        # (c) z jump / (d) overlong reach. Reference quirk preserved
        # (`global_planner.cpp:294`): asin(dz/dxy) is computed UNclamped,
        # so dz > dxy yields NaN and `NaN > 0.349` is false — such segments
        # do NOT trigger the keep. We reproduce that by gating on
        # dz <= dxy instead of clamping.
        dxy = steps * np.hypot(v[0], v[1])
        dz = steps * abs(v[2])
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = dz / np.maximum(dxy, 1e-9)
            ang = np.where(ratio <= 1.0, np.arcsin(np.minimum(ratio, 1.0)),
                           np.nan)
        keep |= bool(np.any((dxy > 0.5) & (ang > 0.349)))
        keep |= bool(np.any(dxy > 20.0))
        if keep:
            out.append(nid)
            anchor = nxt
    out.append(ids[-1])
    return out
