"""Host wrapper owning one map's planning context (counterpart of
``dddmr_navigation_tpu/planning/global_/runtime.py``, the reference
`GlobalPlanner` node's synced ground and graph state,
`global_planner.cpp:156-176`): the ground cloud, the neighbor table and the
static weights live on the device; :meth:`GlobalPlannerRuntime.plan` runs
snap → relax → extract for one robot (B = 1) and turns the node path into
interpolated poses on the host.

Shared by ``MoveBaseDriver`` (direct queries) and ``DWAGlobalPlanManager``
(full plans and windowed replans).

Rounding: the JAX package runs the plan as one jitted program, which also
builds the turning planner's edge bins and turning table; the runtime
builds both once, rounded as that program does (``jit=True``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from navbench.reference.config import NavigationConfig
from navbench.reference.planning.global_.graph import (
    build_ground_graph)
from navbench.reference.planning.global_.planner import (
    GlobalPathResult, path_to_poses, plan_on_graph)
from navbench.reference.planning.global_.wavefront import (
    edge_azimuth, edge_bins, turning_penalty_table)


def long_edge_counts(nbr_dist, nbr_valid, *, inscribed_radius: float,
                     max_long_edges: int):
    """The port's ``planning/global_/los.py::long_edge_counts``: (long
    edges, those the LOS gate checks) of each robot's graph, (B,)."""
    long_edge = nbr_valid & (nbr_dist >= 2.0 * inscribed_radius)
    seen = long_edge.reshape(-1, long_edge.shape[-2] * long_edge.shape[-1]
                             ).sum(dim=1)
    return seen, torch.clamp(seen, max=max_long_edges)


class GlobalPlannerRuntime:
    def __init__(self, cfg: NavigationConfig, ground: np.ndarray,
                 node_weight: Optional[np.ndarray] = None,
                 intensity: Optional[np.ndarray] = None, device="cuda"):
        self.nav_cfg = cfg
        self.cfg = cfg.global_planner
        self.inscribed_radius = cfg.perception.inscribed_radius
        self.device = torch.device(device)
        self.ground = np.asarray(ground, np.float32)
        g = len(self.ground)
        self.node_weight = (np.zeros(g, np.float32) if node_weight is None
                            else np.asarray(node_weight, np.float32))
        self.graph = build_ground_graph(
            self.ground, radius=self.cfg.a_star_expanding_radius,
            k_max=cfg.perception.static_layer.max_ground_neighbors,
            intensity=intensity)

        def t(x):
            return torch.as_tensor(np.asarray(x), device=self.device)
        self.ground_dev = t(self.ground)
        self.ground_valid_dev = torch.ones((g,), dtype=torch.bool,
                                           device=self.device)
        self._nbr_idx = t(self.graph.nbr_idx)
        self._nbr_dist = t(self.graph.nbr_dist)
        self._nbr_valid = t(self.graph.nbr_valid)
        self._avg_int = t(self.graph.avg_intensity)
        self._node_weight = t(self.node_weight)
        # the LOS gate's long edges before and after its cap, one gate run
        seen, kept = long_edge_counts(
            self._nbr_dist, self._nbr_valid,
            inscribed_radius=self.inscribed_radius,
            max_long_edges=self.cfg.max_long_edges)
        self.los_counts = (seen[0], kept[0])
        # the iterations the queries' relaxations ran since the caller last
        # set it to None (a device scalar; never read here)
        self.relax_iters = None
        self._turning = {}
        if self.cfg.turning_weight > 0.0:
            az = edge_azimuth(self.ground_dev, self._nbr_idx)
            self._turning = dict(
                wf_az=az,
                wf_bins=edge_bins(az, self.cfg.turning_dir_bins, jit=True),
                turn_pen=turning_penalty_table(
                    self._nbr_idx, self.ground_dev, self.cfg.turning_weight,
                    jit=True))

    def _row(self, x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=self.device).reshape(1, -1)

    def plan_result(self, start_pos, goal_pos, dgraph, lethal_pts=None,
                    lethal_valid=None) -> GlobalPathResult:
        """The batched (B = 1) :class:`GlobalPathResult` of one query.
        dgraph (G,) or (1, G); lethal_pts (L, 3) or (1, L, 3)."""
        lethal = {}
        if lethal_pts is not None:
            lethal = dict(
                lethal_pts=torch.as_tensor(lethal_pts, device=self.device
                                           ).reshape(1, -1, 3),
                lethal_valid=torch.as_tensor(lethal_valid,
                                             device=self.device
                                             ).reshape(1, -1))
        res = plan_on_graph(
            self.cfg, self._nbr_idx, self._nbr_dist, self._nbr_valid,
            self.ground_dev, self.ground_valid_dev,
            self._row(dgraph), self._node_weight, self._avg_int,
            self._row(start_pos), self._row(goal_pos),
            inscribed_radius=self.inscribed_radius,
            inflation_descending_rate=(
                self.nav_cfg.perception.inflation_descending_rate),
            **lethal, **self._turning)
        self.relax_iters = (res.iters[0] if self.relax_iters is None
                            else self.relax_iters + res.iters[0])
        return res

    def plan(self, start_pos, goal_pos, dgraph, lethal_pts=None,
             lethal_valid=None):
        """Plan → (positions (M, 3), quats (M, 4)) numpy, or None on
        failure."""
        res = self.plan_result(start_pos, goal_pos, dgraph, lethal_pts,
                               lethal_valid)
        if not bool(res.ok[0]):
            return None
        pos, quats = path_to_poses(self.cfg, self.ground, res)
        if len(pos) < 1:
            return None
        return pos, quats
