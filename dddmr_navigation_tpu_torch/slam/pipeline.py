"""Mapping session, the counterpart of
``dddmr_navigation_tpu/slam/pipeline.py`` (lego_loam's node pipeline,
`lego_loam_node.cpp:19-41`: ImageProjection → FeatureAssociation →
MapOptimization).

The per-scan device work is three plain functions on tensors (the JAX
package's three jitted programs): :func:`frontend` (projection and
features), :func:`odometry` (scan-to-keyframe Gauss-Newton) and
:func:`map_refine` (scan-to-map Gauss-Newton against the rebuilt submap).
The host sequences keyframes, loop closures and pose-graph
re-optimization, as in the JAX package. Keyframe features stay on the
device, with one host copy made when the keyframe is added (the JAX
package's ``device_get``), which the submap rebuild (host numpy, with the
port's own ``io.maps.voxel_downsample``) and ``save`` read.

The host reads the device where the JAX package does: the odometry and
refined poses, a new keyframe's features, its pose, the loop candidate
(``bool(found)``), the ICP fitness. The small pose arithmetic between the
stages runs eagerly in the JAX package (op by op, no fused products), so
the port runs it on CPU tensors with the same plain rounding. Artifacts
save in the reference's pose-graph directory format through the port's
``state_estimation.submaps.write_pose_graph``.

While the tracing recorder is on (``runtime/tracing.py``), a processed
scan is a ``scan`` span and each of its stages ("frontend", "odometry",
"map refine", "keyframe", "loop closure") a stage span inside it.
``last_scan`` holds what the last processed scan's stages computed (its
features, the odometry and refined poses, the keyframe decision, the loop
candidate, the ICP result and the optimized graph), for checks against a
recorded run.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from dddmr_navigation_tpu_torch.config import SlamConfig
from dddmr_navigation_tpu_torch.geometry import (
    quat_conjugate, quat_multiply, quat_normalize, quat_rotate)
from dddmr_navigation_tpu_torch.io.maps import voxel_downsample
from dddmr_navigation_tpu_torch.rounding import asin_xla, atan2_xla
from dddmr_navigation_tpu_torch.runtime import tracing
from dddmr_navigation_tpu_torch.slam import pose_graph as pg
from dddmr_navigation_tpu_torch.slam.features import (
    FeatureSet, extract_features)
from dddmr_navigation_tpu_torch.slam.projection import (
    patched_ground_points, project)
from dddmr_navigation_tpu_torch.slam.scan_matching import (
    icp_point2point, match_scans, match_to_map)
from dddmr_navigation_tpu_torch.state_estimation.submaps import (
    PoseGraph, write_pose_graph)

SUBMAP_PAD_VALUE = 1e6


def frontend(cfg: SlamConfig, points, mask) -> FeatureSet:
    """Projection and feature extraction of one scan."""
    return extract_features(cfg, project(cfg, points, mask))


def odometry(cfg: SlamConfig, feats: FeatureSet, ref: FeatureSet,
             init_pos, init_quat):
    """Scan-to-keyframe matching against the reference keyframe's
    features. The plane sources are the decimated less-flat set (walls and
    ground), as the reference's scan-to-map stage (`mapOptimization.cpp:
    1519`)."""
    return match_scans(
        cfg, feats.sharp, feats.sharp_mask,
        feats.less_flat[::4], feats.less_flat_mask[::4],
        ref.less_sharp, ref.less_sharp_mask, ref.less_flat,
        ref.less_flat_mask, init_pos=init_pos, init_quat=init_quat,
        tgt_less_sharp_ring=ref.less_sharp_ring,
        tgt_less_flat_ring=ref.less_flat_ring)


def map_refine(cfg: SlamConfig, feats: FeatureSet, sub_sharp, sub_sharp_m,
               sub_flat, sub_flat_m, init_pos, init_quat):
    """Scan-to-map refinement against the accumulated surrounding-keyframe
    submap (`mapOptimization.cpp:1407-1780` scan2MapOptimization), from the
    scan-to-keyframe pose."""
    return match_to_map(
        cfg, feats.sharp, feats.sharp_mask,
        feats.less_flat[::4], feats.less_flat_mask[::4],
        sub_sharp, sub_sharp_m, sub_flat, sub_flat_m,
        init_pos=init_pos, init_quat=init_quat, iters=cfg.map_match_iters)


def _cpu(x):
    """A host value as a CPU f32 tensor (the eager arithmetic's operand)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32)
    return torch.tensor(np.asarray(x, np.float32))


def _rel(pi, qi, pj, qj):
    """Tᵢ⁻¹·Tⱼ as numpy (rel_pos, rel_quat), rounded as the JAX package's
    eager quaternion ops."""
    qi_inv = quat_conjugate(_cpu(qi))
    rel_q = quat_normalize(quat_multiply(qi_inv, _cpu(qj)))
    rel_p = quat_rotate(qi_inv, _cpu(pj) - _cpu(pi))
    return rel_p.numpy(), rel_q.numpy()


def rpy_xla(q):
    """(roll, pitch, yaw) floats of one quaternion as the JAX package's
    eager ``rpy_from_quat`` gives them (XLA's ``atan2``/``arcsin`` on the
    CPU, plain products)."""
    x, y, z, w = _cpu(q).unbind(-1)
    roll = atan2_xla(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = asin_xla(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = atan2_xla(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return float(roll), float(pitch), float(yaw)


def _host_feats(f: FeatureSet) -> FeatureSet:
    return FeatureSet(*(x.cpu().numpy() for x in f))


@dataclass
class MappingSession:
    """Host-side SLAM loop (feed scans → keyframes → pose graph)."""
    cfg: SlamConfig = field(default_factory=SlamConfig)
    device: torch.device | str = "cuda"
    # pose of the latest scan w.r.t. map (host)
    cur_pos: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float32))
    cur_quat: np.ndarray = field(
        default_factory=lambda: np.array([0, 0, 0, 1], np.float32))
    keyframe_feats: list = field(default_factory=list)  # FeatureSet, device
    keyframe_host: list = field(default_factory=list)   # FeatureSet, numpy
    # per-keyframe patched ground and ground-edge clouds (sensor frame),
    # the reference's `patchedGroundKeyFrames` (`mapOptimization.cpp:
    # 211-217`)
    keyframe_ground: list = field(default_factory=list)
    keyframe_ground_edge: list = field(default_factory=list)
    n_keyframes: int = 0
    n_edges: int = 0
    graph: Optional[pg.PoseGraphArrays] = None
    loop_closures: list = field(default_factory=list)
    paused: bool = False
    last_scan: dict = field(default_factory=dict)
    _submap: Optional[tuple] = None

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.graph is None:
            self.graph = pg.empty_graph(self.cfg.max_keyframes,
                                        self.cfg.max_edges, self.device)

    def _t(self, x):
        """A host array as an f32 tensor on the session's device."""
        return torch.tensor(np.asarray(x, np.float32), device=self.device)

    # -- surrounding-keyframe submap (`extractSurroundingKeyFrames`,
    # `mapOptimization.cpp:1192-1230`: recent-N keyframe queue in map frame)
    def _rebuild_submap(self):
        n_take = self.cfg.surrounding_keyframe_search_num
        if n_take <= 1 or self.n_keyframes == 0:
            self._submap = None
            return
        first = max(0, self.n_keyframes - n_take)
        sharp_all, flat_all = [], []
        for i in range(first, self.n_keyframes):
            p, q = self._kf_pose(i)
            f = self.keyframe_host[i]
            qj = _cpu(q)

            def to_map(pts, mask):
                sel = pts[mask]
                if not len(sel):
                    return sel
                return quat_rotate(qj[None, :], _cpu(sel)).numpy() \
                    + p[None, :]

            sharp_all.append(to_map(f.less_sharp, f.less_sharp_mask))
            flat_all.append(to_map(f.less_flat, f.less_flat_mask))
        sharp = np.concatenate([s for s in sharp_all if len(s)]) \
            if any(len(s) for s in sharp_all) else np.zeros((0, 3), np.float32)
        flat = np.concatenate([s for s in flat_all if len(s)]) \
            if any(len(s) for s in flat_all) else np.zeros((0, 3), np.float32)
        sharp = voxel_downsample(sharp, self.cfg.submap_corner_leaf)
        flat = voxel_downsample(flat, self.cfg.submap_surf_leaf)

        def pad(pts, n):
            if len(pts) > n:
                stride = int(np.ceil(len(pts) / n))
                pts = pts[::stride][:n]
            out = np.full((n, 3), SUBMAP_PAD_VALUE, np.float32)
            out[:len(pts)] = pts
            m = np.zeros((n,), bool)
            m[:len(pts)] = True
            return self._t(out), torch.tensor(m, device=self.device)

        ss, sm = pad(sharp, self.cfg.submap_sharp_pad)
        fs, fm = pad(flat, self.cfg.submap_flat_pad)
        self._submap = (ss, sm, fs, fm)

    # -- helpers ----------------------------------------------------------
    def _kf_pose(self, i):
        """Keyframe i's pose as host numpy (a device read)."""
        return (self.graph.pos[i].cpu().numpy(),
                self.graph.quat[i].cpu().numpy())

    # -- main entry ---------------------------------------------------------
    def pause(self):
        """Mapping panel 'pause' (`mapping_panel.cpp:88-106`): scans are
        ignored until :meth:`resume`; the pose and graph hold still."""
        self.paused = True

    def resume(self):
        self.paused = False

    def process_scan(self, points, mask):
        """Feed one sweep (sensor frame; array-likes or tensors). Returns
        the current map pose (host numpy)."""
        with tracing.span("scan"):
            return self._process_scan(points, mask)

    def _process_scan(self, points, mask):
        if self.paused:
            return self.cur_pos, self.cur_quat
        points = torch.as_tensor(points, dtype=torch.float32,
                                 device=self.device)
        mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        tracing.stage("frontend")
        feats = frontend(self.cfg, points, mask)
        last = self.last_scan = {"feats": feats, "keyframe": False}

        if self.n_keyframes == 0:
            tracing.stage("keyframe")
            last["keyframe"] = True
            self._add_keyframe(feats, scan=(points, mask))
            return self.cur_pos, self.cur_quat

        tracing.stage("odometry")
        ref_i = self.n_keyframes - 1
        ref_pos, ref_quat = self._kf_pose(ref_i)
        init_p, init_q = _rel(ref_pos, ref_quat, self.cur_pos, self.cur_quat)
        rel_pos, rel_quat, _ = odometry(
            self.cfg, feats, self.keyframe_feats[ref_i], self._t(init_p),
            self._t(init_q))
        # compose: T_map_cur = T_map_kf · T_kf_cur
        rq = _cpu(ref_quat)
        self.cur_quat = quat_normalize(quat_multiply(rq, _cpu(rel_quat))
                                       ).numpy()
        self.cur_pos = ref_pos + quat_rotate(rq, _cpu(rel_pos)).numpy()
        last["odom"] = (self.cur_pos, self.cur_quat)

        # scan-to-map refinement vs the accumulated submap
        if self._submap is not None:
            tracing.stage("map refine")
            mpos, mquat, _ = map_refine(
                self.cfg, feats, *self._submap, self._t(self.cur_pos),
                self._t(self.cur_quat))
            self.cur_pos = mpos.cpu().numpy()
            self.cur_quat = mquat.cpu().numpy()
            last["refined"] = (self.cur_pos, self.cur_quat)

        if self._keyframe_due(ref_pos, ref_quat):
            tracing.stage("keyframe")
            last["keyframe"] = True
            self._add_keyframe(feats, parent=ref_i, scan=(points, mask))
            if self.cfg.enable_loop_closure:
                tracing.stage("loop closure")
                self._try_loop_closure()
        return self.cur_pos, self.cur_quat

    def _keyframe_due(self, ref_pos, ref_quat):
        """`saveKeyFramesAndFactor` gate: 1 m / 1 rad from last keyframe
        (`distance_between_key_frame` / `angle_between_key_frame`)."""
        d = float(np.linalg.norm(self.cur_pos - ref_pos))
        qrel = quat_multiply(quat_conjugate(_cpu(ref_quat)),
                             _cpu(self.cur_quat))
        a = float(2.0 * np.arccos(np.clip(abs(float(qrel[3])), 0, 1)))
        return (d > self.cfg.distance_between_key_frame
                or a > self.cfg.angle_between_key_frame)

    def _add_keyframe(self, feats, parent: int | None = None, scan=None):
        i = self.n_keyframes
        if i >= self.cfg.max_keyframes:
            raise RuntimeError(f"max_keyframes ({self.cfg.max_keyframes}) "
                               f"exceeded")
        self.graph = pg.add_node(self.graph, i, self.cur_pos, self.cur_quat)
        self.keyframe_feats.append(feats)
        self.keyframe_host.append(_host_feats(feats))
        if scan is not None:
            # patched-ground keyframe processing (`imageProjection.cpp:
            # 408-516`), from the scan projected as the JAX package's
            # eager call projects it
            img = project(self.cfg, scan[0], scan[1], eager=True)
            gpts, epts = patched_ground_points(
                self.cfg, img.pts, img.valid, img.ground,
                first_frame=(i == 0))
            self.keyframe_ground.append(gpts)
            self.keyframe_ground_edge.append(epts)
        else:
            self.keyframe_ground.append(None)
            self.keyframe_ground_edge.append(None)
        self.n_keyframes += 1
        if parent is not None:
            pp, pq = self._kf_pose(parent)
            rel_p, rel_q = _rel(pp, pq, self.cur_pos, self.cur_quat)
            self.graph = pg.add_edge(self.graph, self.n_edges, parent, i,
                                     rel_p, rel_q, weight=1.0)
            self.n_edges += 1
        self._rebuild_submap()

    def _icp(self, i: int, j: int, max_corr: float, jp, jq):
        """ICP of keyframe j's less-flat + less-sharp cloud onto keyframe
        i's, from i's graph pose and j's pose (jp, jq): (pos, quat,
        fitness float)."""
        cf, hf = self.keyframe_feats[j], self.keyframe_feats[i]
        pp, pq = self._kf_pose(i)
        init_p, init_q = _rel(pp, pq, jp, jq)
        pos, quat, fitness = icp_point2point(
            torch.cat([cf.less_flat, cf.less_sharp]),
            torch.cat([cf.less_flat_mask, cf.less_sharp_mask]),
            torch.cat([hf.less_flat, hf.less_sharp]),
            torch.cat([hf.less_flat_mask, hf.less_sharp_mask]),
            self.cfg.icp_iters, max_corr, self._t(init_p), self._t(init_q))
        return pos, quat, float(fitness)

    def _close(self, i: int, j: int, pos, quat, fitness: float):
        """Add the verified loop edge i → j, re-optimize, and follow the
        corrected latest keyframe (`correctPoses`)."""
        w = 1.0 / max(fitness, 1e-3)
        self.graph = pg.add_edge(self.graph, self.n_edges, i, j, pos, quat,
                                 weight=min(w, 100.0))
        self.n_edges += 1
        self.loop_closures.append((i, j, fitness))
        self.graph = pg.optimize_pose_graph(self.graph,
                                            self.cfg.pose_graph_iters)
        self.last_scan["graph"] = self.graph
        self.cur_pos, self.cur_quat = self._kf_pose(self.n_keyframes - 1)
        self._rebuild_submap()

    def _try_loop_closure(self):
        cur = self.n_keyframes - 1
        cand, found = pg.detect_loop_candidate(
            self.graph, cur, self.cfg.history_keyframe_search_radius,
            min_index_gap=int(self.cfg.history_keyframe_search_radius))
        if not bool(found):
            self.last_scan["loop_candidate"] = (-1, False)
            return False
        cand = int(cand)
        self.last_scan["loop_candidate"] = (cand, True)
        # verify with ICP between the less-flat clouds in candidate frame
        pos, quat, fitness = self._icp(cand, cur, 2.0, self.cur_pos,
                                       self.cur_quat)
        self.last_scan["icp"] = (pos, quat, fitness)
        if fitness > self.cfg.history_keyframe_fitness_score:
            return False
        self._close(cand, cur, pos, quat, fitness)
        return True

    def manual_loop(self, i: int, j: int, max_corr: float = 2.0,
                    fitness_gate: float | None = None):
        """Interactive in-mapping pose-graph edit: ICP between two chosen
        keyframes, the verified loop edge, and a batch re-optimization
        (`interactive_pose_graph_editor.cpp:1-432`).

        Args:
          i: anchor (earlier) keyframe index.
          j: keyframe to close against (``i < j < n_keyframes``).
          fitness_gate: accept threshold; defaults to the config's
            ``history_keyframe_fitness_score``.
        Returns (accepted, fitness)."""
        if not 0 <= i < j < self.n_keyframes:
            raise ValueError(f"need 0 <= i < j < {self.n_keyframes}: "
                             f"{(i, j)}")
        gate = (self.cfg.history_keyframe_fitness_score
                if fitness_gate is None else fitness_gate)
        pos, quat, fitness = self._icp(i, j, max_corr, *self._kf_pose(j))
        if fitness > gate:
            return False, fitness
        self._close(i, j, pos, quat, fitness)
        return True, fitness

    # -- artifacts ----------------------------------------------------------
    def pose_graph(self) -> PoseGraph:
        """The map as the reference's pose graph: poses, each keyframe's
        corner features (`{i}_feature.pcd`) and patched ground
        (`{i}_ground.pcd`; the ground-flagged less-flat picks for a
        keyframe recorded without a scan) (`mapOptimization.cpp:191-217,
        277-293`)."""
        k = self.n_keyframes
        poses = np.zeros((k, 8), np.float32)
        feats, grounds = [], []
        for i in range(k):
            p, q = self._kf_pose(i)
            poses[i, :3] = p
            poses[i, 4:7] = rpy_xla(q)
            f = self.keyframe_host[i]
            feats.append(f.less_sharp[f.less_sharp_mask])
            pg_cloud = (self.keyframe_ground[i]
                        if i < len(self.keyframe_ground) else None)
            grounds.append(pg_cloud if pg_cloud is not None
                           and len(pg_cloud) else
                           f.less_flat[f.less_flat_mask & f.less_flat_ground])
        return PoseGraph(poses=poses, feature_clouds=feats,
                         ground_clouds=grounds)

    def save(self, out_dir: str):
        """Write :meth:`pose_graph` in the reference pose-graph directory
        format, with the stitched map and ground clouds."""
        write_pose_graph(out_dir, self.pose_graph())
