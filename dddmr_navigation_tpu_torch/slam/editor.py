"""Offline pose-graph editing, the counterpart of
``dddmr_navigation_tpu/slam/editor.py`` (the reference's pose-graph
editor and merge-editor nodes,
`lego_loam_bor/src/pose_graph_editor/pose_graph_editor.cpp:1-978`,
`pose_graph_merge_editor.cpp`, and the rviz editor panels).

The operations are a host-side API over the on-disk pose-graph directory
format (the port's ``submaps.read_pose_graph``/``write_pose_graph``):
delete loop edges, add a manual ICP edge between chosen keyframes (with
the panel's nudges), re-optimize by batch Gauss-Newton, rotate and
translate whole graphs, merge sessions, export. ICP and re-optimization
run on ``device`` (``icp_point2point``, ``optimize_pose_graph``); the small
pose arithmetic runs eagerly on the host, as in the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from dddmr_navigation_tpu_torch.geometry import (
    quat_conjugate, quat_from_rpy, quat_multiply, quat_rotate)
from dddmr_navigation_tpu_torch.slam import pose_graph as pg
from dddmr_navigation_tpu_torch.slam.pipeline import rpy_xla
from dddmr_navigation_tpu_torch.slam.scan_matching import icp_point2point
from dddmr_navigation_tpu_torch.state_estimation.submaps import (
    PoseGraph, read_pose_graph, write_pose_graph)


def _f32(*xs):
    return [torch.tensor(np.float32(x)) for x in xs]


def _pose_quat(row: np.ndarray) -> np.ndarray:
    return quat_from_rpy(*_f32(row[4], row[5], row[6])).numpy()


def _rel(pi, qi, pj, qj):
    """Tᵢ⁻¹·Tⱼ as (rel_pos, rel_quat) numpy."""
    qi = torch.tensor(np.asarray(qi, np.float32))
    qj = torch.tensor(np.asarray(qj, np.float32))
    qi_inv = quat_conjugate(qi)
    rel_q = quat_multiply(qi_inv, qj)
    rel_p = quat_rotate(qi_inv, torch.tensor(
        np.asarray(pj, np.float32) - np.asarray(pi, np.float32)))
    return rel_p.numpy(), rel_q.numpy()


@dataclass
class GraphEditor:
    """In-memory editing session over one (or a merged) pose graph.

    ``edges`` rows are dicts (i, j, rel_pos(3), rel_quat(4), weight,
    kind); the odometry chain is rebuilt from consecutive poses on load,
    as the reference editor rebuilds between-factors from poses.pcd and
    edges.pcd. ``device``: where ICP and the optimization run.
    """
    graph: PoseGraph
    edges: list[dict] = field(default_factory=list)
    device: torch.device | str = "cuda"

    # -- construction --------------------------------------------------
    @classmethod
    def load(cls, pose_graph_dir: str, device="cuda") -> "GraphEditor":
        g = read_pose_graph(pose_graph_dir)
        ed = cls(graph=g, device=device)
        ed._rebuild_odom_edges()
        # loop edges from edges.pcd: rows of (i, j) node indices
        if g.edges is not None:
            for row in np.asarray(g.edges):
                i, j = int(row[0]), int(row[1])
                if abs(i - j) > 1:
                    ed._add_edge_from_poses(i, j, weight=1.0, kind="loop")
        return ed

    @classmethod
    def from_graph(cls, graph: PoseGraph, device="cuda") -> "GraphEditor":
        ed = cls(graph=graph, device=device)
        ed._rebuild_odom_edges()
        return ed

    def _rebuild_odom_edges(self):
        for i in range(len(self.graph.poses) - 1):
            self._add_edge_from_poses(i, i + 1, weight=1.0, kind="odom")

    def _add_edge_from_poses(self, i: int, j: int, weight: float,
                             kind: str):
        pi, pj = self.graph.poses[i], self.graph.poses[j]
        rel_p, rel_q = _rel(pi[:3], _pose_quat(pi), pj[:3], _pose_quat(pj))
        self.edges.append(dict(i=i, j=j, rel_pos=rel_p, rel_quat=rel_q,
                               weight=weight, kind=kind))

    # -- edits ----------------------------------------------------------
    def delete_edge(self, i: int, j: int) -> bool:
        """Remove the edge between keyframes i and j (either direction),
        the panel's delete-selected-edges action."""
        n0 = len(self.edges)
        self.edges = [e for e in self.edges
                      if {e["i"], e["j"]} != {i, j}]
        return len(self.edges) < n0

    def add_icp_edge(self, i: int, j: int, iters: int = 30,
                     max_corr_dist: float = 2.0,
                     init_nudge: np.ndarray | None = None) -> float:
        """Manual loop closure between keyframes i and j: ICP of j's
        feature cloud onto i's from the current relative pose (optionally
        nudged by (dx, dy, dz, droll, dpitch, dyaw), the panel's buttons).
        Returns the ICP fitness; the edge weight is 1/fitness as in
        `addEdgeFromPose` (`mapOptimization.cpp:1162-1177`)."""
        pi, pj = self.graph.poses[i], self.graph.poses[j]
        init_p, init_q = _rel(pi[:3], _pose_quat(pi), pj[:3], _pose_quat(pj))
        if init_nudge is not None:
            n = np.asarray(init_nudge, np.float32)
            init_p = init_p + n[:3]
            init_q = quat_multiply(torch.tensor(init_q),
                                   quat_from_rpy(*_f32(n[3], n[4], n[5]))
                                   ).numpy()
        src = np.asarray(self.graph.feature_clouds[j], np.float32)[:, :3]
        tgt = np.asarray(self.graph.feature_clouds[i], np.float32)[:, :3]
        m = max(len(src), len(tgt), 8)
        src_p = np.zeros((m, 3), np.float32)
        src_p[:len(src)] = src
        tgt_p = np.zeros((m, 3), np.float32)
        tgt_p[:len(tgt)] = tgt
        dev = self.device

        def t(x):
            return torch.tensor(x, device=dev)
        pos, quat, fitness = icp_point2point(
            t(src_p), t(np.arange(m) < len(src)), t(tgt_p),
            t(np.arange(m) < len(tgt)), iters, max_corr_dist,
            t(np.asarray(init_p, np.float32)),
            t(np.asarray(init_q, np.float32)))
        fitness = float(fitness)
        self.edges.append(dict(
            i=i, j=j, rel_pos=pos.cpu().numpy(), rel_quat=quat.cpu().numpy(),
            weight=min(1.0 / max(fitness, 1e-3), 100.0), kind="loop"))
        return fitness

    def translate(self, offset) -> None:
        """Translate the whole graph (`pose_graph_editor.cpp:919-954`)."""
        self.graph.poses[:, :3] += np.asarray(offset, np.float32)[None, :]

    def rotate_yaw(self, angle: float, about=(0.0, 0.0, 0.0)) -> None:
        """Rotate the whole graph about the z-axis through ``about``."""
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        about = np.asarray(about, np.float32)
        p = self.graph.poses
        p[:, :3] = (p[:, :3] - about) @ rot.T + about
        p[:, 6] += angle  # yaw column

    # -- optimization ----------------------------------------------------
    def optimize(self, iters: int = 8) -> None:
        """Re-optimize all poses from the current edge set (the editor's
        fresh-iSAM2 re-run, `pose_graph_editor.cpp:169,278`) and write the
        corrected poses back into the graph rows (`correctPoses`)."""
        k = len(self.graph.poses)
        e = max(len(self.edges), 1)
        g = pg.empty_graph(k, e, self.device)
        for idx in range(k):
            row = self.graph.poses[idx]
            g = pg.add_node(g, idx, row[:3], _pose_quat(row))
        for eidx, ed in enumerate(self.edges):
            g = pg.add_edge(g, eidx, ed["i"], ed["j"], ed["rel_pos"],
                            ed["rel_quat"], ed["weight"])
        g = pg.optimize_pose_graph(g, iters)
        pos, quat = g.pos.cpu().numpy(), g.quat.cpu().numpy()
        for idx in range(k):
            self.graph.poses[idx, :3] = pos[idx]
            self.graph.poses[idx, 4:7] = rpy_xla(quat[idx])

    # -- merge -----------------------------------------------------------
    def merge(self, other: PoseGraph, connect: tuple[int, int] | None = None,
              icp_iters: int = 30) -> None:
        """Append a second session's graph (`pose_graph_merge_editor`):
        keyframes re-indexed after this graph's; ``connect=(i_self,
        j_other)`` adds an ICP edge binding the sessions."""
        base = len(self.graph.poses)
        self.graph.poses = np.concatenate(
            [self.graph.poses, np.asarray(other.poses, np.float32)])
        self.graph.feature_clouds = (list(self.graph.feature_clouds)
                                     + list(other.feature_clouds))
        self.graph.ground_clouds = (list(self.graph.ground_clouds)
                                    + list(other.ground_clouds))
        for i in range(len(other.poses) - 1):
            self._add_edge_from_poses(base + i, base + i + 1, 1.0, "odom")
        if connect is not None:
            self.add_icp_edge(connect[0], base + connect[1],
                              iters=icp_iters)

    # -- export ----------------------------------------------------------
    def save(self, out_dir: str) -> None:
        """Export poses/edges, per-keyframe clouds and the stitched
        map/ground (`pose_graph_editor.cpp:713-746`)."""
        loop = [(e["i"], e["j"]) for e in self.edges if e["kind"] == "loop"]
        edges = (np.asarray([(i, j, 0.0) for i, j in loop], np.float32)
                 if loop else None)
        write_pose_graph(out_dir, PoseGraph(
            poses=self.graph.poses, feature_clouds=self.graph.feature_clouds,
            ground_clouds=self.graph.ground_clouds, edges=edges))
