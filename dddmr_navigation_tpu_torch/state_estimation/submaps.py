"""Pose-graph submaps, the analogue of ``mcl_3dl::SubMaps``
(`src/dddmr_mcl_3dl/src/sub_maps.cpp:87-326`).

Counterpart of ``dddmr_navigation_tpu/state_estimation/submaps.py``. The
pose-graph files and the stitching are host numpy, copied whole from it
(``PoseGraph``, ``_rpy_matrix``, ``transform_keyframe``,
``read_pose_graph``, ``write_pose_graph``, ``stitch_submap``). The artifact
format is the reference's (what `MapOptimization::pcdSaver` writes,
`mapOptimization.cpp:171-292`):

    <dir>/poses.pcd              keyframe poses, fields x y z intensity
                                 roll pitch yaw time (base_link in map)
    <dir>/pcd/<i>_feature.pcd    per-keyframe corner/feature cloud (base)
    <dir>/pcd/<i>_ground.pcd     per-keyframe ground cloud (base)
    <dir>/map.pcd, ground.pcd    stitched global clouds
    <dir>/edges.pcd              pose-graph edges (i, j, type)

:class:`SubmapManager` keeps the reference's policy: a warm-up thread
prepares the next :class:`SubmapContext` once the robot drifts
``warmup_trigger_distance`` from the current submap's center, and the
caller swaps it in between ticks. The thread builds the context's host
arrays only (on the CPU); :meth:`SubmapManager.current` uploads them on the
caller's thread and stream, so a tick that follows the swap on that stream
reads a complete context.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field

import numpy as np

from dddmr_navigation_tpu_torch.config import MCLConfig
from dddmr_navigation_tpu_torch.io import read_pcd, write_pcd
from dddmr_navigation_tpu_torch.state_estimation.likelihood import (
    DistanceField, SubmapContext, build_submap_context)

POSE_FIELDS = ("x", "y", "z", "intensity", "roll", "pitch", "yaw", "time")


@dataclass
class PoseGraph:
    """Host-side pose-graph payload."""
    poses: np.ndarray                     # (K, 8) POSE_FIELDS
    feature_clouds: list[np.ndarray]      # K × (Ni, 3+) base_link frame
    ground_clouds: list[np.ndarray]       # K × (Mi, 3+) base_link frame
    edges: np.ndarray | None = None       # (E, 3+) optional


def _rpy_matrix(roll, pitch, yaw):
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr]], np.float32)


def transform_keyframe(points: np.ndarray, pose_row: np.ndarray) -> np.ndarray:
    """base_link cloud → map frame using a poses.pcd row (the reference's
    setRPY + transformPointCloud, `sub_maps.cpp:130-148`)."""
    r = _rpy_matrix(pose_row[4], pose_row[5], pose_row[6])
    out = points[:, :3] @ r.T + pose_row[:3][None, :]
    if points.shape[1] > 3:
        out = np.concatenate([out, points[:, 3:]], axis=1)
    return out


def read_pose_graph(pose_graph_dir: str) -> PoseGraph:
    """`SubMaps::readPoseGraph` (`sub_maps.cpp:87-150`)."""
    poses = read_pcd(os.path.join(pose_graph_dir, "poses.pcd"))
    feats, grounds = [], []
    for i in range(len(poses)):
        feats.append(read_pcd(
            os.path.join(pose_graph_dir, "pcd", f"{i}_feature.pcd")))
        grounds.append(read_pcd(
            os.path.join(pose_graph_dir, "pcd", f"{i}_ground.pcd")))
    edges_path = os.path.join(pose_graph_dir, "edges.pcd")
    edges = read_pcd(edges_path) if os.path.exists(edges_path) else None
    return PoseGraph(poses=poses, feature_clouds=feats,
                     ground_clouds=grounds, edges=edges)


def write_pose_graph(pose_graph_dir: str, graph: PoseGraph) -> None:
    """Reference-compatible pcdSaver output
    (`mapOptimization.cpp:171-292`): poses + per-keyframe clouds + stitched
    map/ground."""
    os.makedirs(os.path.join(pose_graph_dir, "pcd"), exist_ok=True)
    poses = np.asarray(graph.poses, np.float32)
    if poses.shape[1] < 8:
        pad = np.zeros((len(poses), 8 - poses.shape[1]), np.float32)
        poses = np.concatenate([poses, pad], axis=1)
    write_pcd(os.path.join(pose_graph_dir, "poses.pcd"), poses,
              fields=POSE_FIELDS)
    map_parts, ground_parts = [], []
    for i, (f, g) in enumerate(zip(graph.feature_clouds, graph.ground_clouds)):
        write_pcd(os.path.join(pose_graph_dir, "pcd", f"{i}_feature.pcd"),
                  np.asarray(f, np.float32)[:, :3])
        write_pcd(os.path.join(pose_graph_dir, "pcd", f"{i}_ground.pcd"),
                  np.asarray(g, np.float32)[:, :3])
        map_parts.append(transform_keyframe(np.asarray(f, np.float32),
                                            poses[i])[:, :3])
        ground_parts.append(transform_keyframe(np.asarray(g, np.float32),
                                               poses[i])[:, :3])
    if map_parts:
        write_pcd(os.path.join(pose_graph_dir, "map.pcd"),
                  np.concatenate(map_parts))
        write_pcd(os.path.join(pose_graph_dir, "ground.pcd"),
                  np.concatenate(ground_parts))
    if graph.edges is not None:
        write_pcd(os.path.join(pose_graph_dir, "edges.pcd"),
                  np.asarray(graph.edges, np.float32))


def stitch_submap(graph: PoseGraph, center_xyz, radius: float):
    """Keyframes within ``radius`` of center → stitched (map, ground)
    clouds in the map frame (`sub_maps.cpp:240-276` semantics)."""
    d = np.linalg.norm(graph.poses[:, :3] - np.asarray(center_xyz)[None, :3],
                       axis=1)
    sel = np.nonzero(d <= radius)[0]
    if len(sel) == 0:
        sel = np.array([int(np.argmin(d))])
    map_pts = np.concatenate([
        transform_keyframe(np.asarray(graph.feature_clouds[i], np.float32),
                           graph.poses[i])[:, :3] for i in sel])
    ground_pts = np.concatenate([
        transform_keyframe(np.asarray(graph.ground_clouds[i], np.float32),
                           graph.poses[i])[:, :3] for i in sel])
    return map_pts, ground_pts


def _to_device(ctx: SubmapContext, device) -> SubmapContext:
    """A copy of a context on ``device``, on the current stream."""
    def t(x):
        return x if x is None else x.to(device)

    def fld(f: DistanceField):
        return DistanceField(dist=t(f.dist), origin=t(f.origin), res=f.res,
                             packed=t(f.packed), near_pt=t(f.near_pt))
    return SubmapContext(
        map_field=fld(ctx.map_field), ground_field=fld(ctx.ground_field),
        ground_normal=t(ctx.ground_normal), ground_count=t(ctx.ground_count),
        ground_xy_res=ctx.ground_xy_res,
        ground_xy_origin=t(ctx.ground_xy_origin))


@dataclass
class SubmapManager:
    """Double-buffered submap prefetch (`SubMaps::warmUpThread` +
    `swapKdTree`, `sub_maps.cpp:219-326`): a background thread rebuilds the
    context when the robot drifts ``warmup_trigger_distance`` from the
    current submap center; :meth:`current` swaps it in when ready."""
    graph: PoseGraph
    cfg: MCLConfig
    search_radius: float = 50.0
    warmup_trigger_distance: float = 20.0
    res: float = 0.15
    device: str = "cuda"
    _ctx: SubmapContext | None = None
    _center: np.ndarray | None = None
    _next: SubmapContext | None = None      # host (CPU) tensors
    _next_center: np.ndarray | None = None
    _thread: threading.Thread | None = None
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def initialize(self, pose_xyz) -> SubmapContext:
        self._center = np.asarray(pose_xyz, np.float32)[:3]
        m, g = stitch_submap(self.graph, self._center, self.search_radius)
        self._ctx = build_submap_context(m, g, self.cfg, res=self.res,
                                         device=self.device)
        return self._ctx

    def _warmup(self, center):
        m, g = stitch_submap(self.graph, center, self.search_radius)
        ctx = build_submap_context(m, g, self.cfg, res=self.res,
                                   device="cpu")
        with self._lock:
            self._next, self._next_center = ctx, center

    def current(self, pose_xyz) -> SubmapContext:
        """Call once per tick with the current pose estimate (a 3-vector
        on the host)."""
        if self._ctx is None:
            raise RuntimeError("call initialize() first")
        pose = np.asarray(pose_xyz, np.float32)[:3]
        with self._lock:
            ready, center = self._next, self._next_center
            self._next = self._next_center = None
        if ready is not None:
            self._ctx, self._center = _to_device(ready, self.device), center
        drift = float(np.linalg.norm(pose - self._center))
        if (drift > self.warmup_trigger_distance
                and (self._thread is None or not self._thread.is_alive())):
            self._thread = threading.Thread(
                target=self._warmup, args=(pose.copy(),), daemon=True)
            self._thread.start()
        return self._ctx

    def join(self, timeout: float | None = None) -> bool:
        """Wait for a warm-up in flight; True when none is left running."""
        if self._thread is not None:
            self._thread.join(timeout)
            return not self._thread.is_alive()
        return True
