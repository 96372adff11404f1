"""NavigationSession: one robot's whole perception → planning → control
loop (counterpart of ``dddmr_navigation_tpu/control/session.py``; the
reference runs it as `Perception3D_ROS`, `StackedPerception`, the global
and local planners and `P2PMoveBase`).

Per tick:
  1. mark/clear the dynamic layer from the live scan at
     ``sensors_collected_frequency`` (`stacked_perception.cpp:72-90`), and
     the depth-camera layer from its frame rings;
  2. min-compose the static, dynamic, depth and (under its toggle)
     no-entry fields (`stacked_perception.cpp:114-126`) and aggregate the
     lethal cloud (`:142-155`) for the planner's LOS gate;
  3. build the observation from the transformed scan
     (`multilayer_spinning_lidar.cpp:264-269`) for the critics and the
     path-blocked strategy;
  4. evaluate the speed-zone cap (`speed_limit_layer.cpp:222-300`);
  5. drive :class:`MoveBaseDriver` with the freshness and TF gates.

The device state is batched with B = 1. Rounding follows the JAX call
sites: the scan transform, ``speed_limit_at`` and ``no_entry_dgraph`` run
eagerly there, so the port uses their plain forms; the perception, depth
and lethal-cloud stages are jitted there, and the port's functions round
as those programs do. While the tracing recorder is on
(``runtime/tracing.py``), a tick is a ``tick`` span and each of its
stages (perception, depth, composition+lethal, then
:class:`MoveBaseDriver`'s plan manager, local tick and FSM) a stage span
inside it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dddmr_navigation_tpu_torch.config import NavigationConfig
from dddmr_navigation_tpu_torch.control.fused import _specs
from dddmr_navigation_tpu_torch.control.move_base import MoveBaseDriver
from dddmr_navigation_tpu_torch.geometry import quat_rotate
from dddmr_navigation_tpu_torch.io.maps import voxel_downsample
from dddmr_navigation_tpu_torch.perception.depth_camera import (
    CameraModel, depth_layer_update, init_depth_buffer, push_observation)
from dddmr_navigation_tpu_torch.perception.layers import (
    min_dgraph, no_entry_dgraph, speed_limit_at)
from dddmr_navigation_tpu_torch.perception.marking import (
    init_marking_state, perception_update)
from dddmr_navigation_tpu_torch.perception.static_map import (
    build_map_context)
from dddmr_navigation_tpu_torch.perception.stitcher import ScanStitcher
from dddmr_navigation_tpu_torch.planning.global_.los import (
    lethal_cloud_from_dgraph)
from dddmr_navigation_tpu_torch.planning.local.planner import (
    make_global_plan)
from dddmr_navigation_tpu_torch.runtime import tracing
from dddmr_navigation_tpu_torch.runtime.watchdog import FreshnessGate


class NavigationSession:
    """One robot's complete navigation vertical over a loaded map."""

    def __init__(self, cfg: NavigationConfig, ground: np.ndarray,
                 map_pts: Optional[np.ndarray] = None,
                 node_weight: Optional[np.ndarray] = None,
                 static_dgraph: Optional[np.ndarray] = None,
                 no_entry_zones: Optional[np.ndarray] = None,
                 speed_zones: Optional[tuple] = None,
                 threaded_plan_manager: bool = False,
                 sensor_offset=(0.0, 0.0, 0.5),
                 depth_cameras: int = 0,
                 depth_camera_model: Optional[CameraModel] = None,
                 depth_buffer_depth: int = 3,
                 depth_max_points: int = 1024,
                 depth_keep_time: float = 0.5,
                 device="cuda"):
        self.cfg = cfg
        p = cfg.perception
        self.device = dev = torch.device(device)
        self.ground = np.asarray(ground, np.float32)
        g = len(self.ground)
        self.spec, self.ri_spec, self.params = _specs(cfg)
        self.map_ctx = build_map_context(self.ground, map_pts,
                                         node_weight=node_weight,
                                         device=dev)
        self._origin0 = torch.zeros((1, 3), device=dev)
        self.marking = init_marking_state(self.spec, self.params, g,
                                          self._origin0)
        self.ground_dev = torch.as_tensor(self.ground, device=dev)
        self.ground_valid = torch.ones((g,), dtype=torch.bool, device=dev)

        # the static layer's field (overhang lethals from map preprocessing)
        self.static_dgraph = (
            torch.full((g,), p.max_obstacle_distance, device=dev)
            if static_dgraph is None else
            torch.as_tensor(np.asarray(static_dgraph, np.float32),
                            device=dev))

        # the no-entry layer: the zone field is precomputed; the toggle
        # (`no_entry_layer.cpp` enable service) composes it in or not
        self.no_entry_enabled = no_entry_zones is not None
        self.no_entry_field = None
        if no_entry_zones is not None:
            zp = torch.as_tensor(np.asarray(no_entry_zones, np.float32),
                                 device=dev)
            self.no_entry_field = no_entry_dgraph(
                self.ground_dev, self.ground_valid, zp,
                torch.ones((len(zp),), dtype=torch.bool, device=dev),
                inflation_distance=p.inflation_radius,
                max_obstacle_distance=p.max_obstacle_distance)

        self.speed_pts = None
        if speed_zones is not None:
            zpts, zspeed = speed_zones
            self.speed_pts = torch.as_tensor(np.asarray(zpts, np.float32),
                                             device=dev)
            self.speed_valid = torch.ones((len(zpts),), dtype=torch.bool,
                                          device=dev)
            self.speed_val = torch.as_tensor(
                np.asarray(zspeed, np.float32), device=dev)

        self.driver = MoveBaseDriver(
            cfg, self.ground, node_weight=node_weight,
            threaded_plan_manager=threaded_plan_manager, device=dev)
        self.sensor_offset = np.asarray(sensor_offset, np.float32)
        self.gate = FreshnessGate(expected_dt={
            "scan": max(2.0 / p.sensors_collected_frequency,
                        2.0 * p.lidar.expected_sensor_time),
            "odom": 0.5,
        })
        self._last_perception_t = -1e9
        self.composed_dgraph = self.static_dgraph
        self.lethal = None
        self.stitcher = ScanStitcher(p.lidar.stitcher_num,
                                     pad_to=p.lidar.max_scan_points)

        # the depth-camera layer: its own marking grid and distance field,
        # cleared against every live buffered frustum, min-composed below
        self.n_depth_cameras = depth_cameras
        if depth_cameras > 0:
            self.depth_cam = depth_camera_model or CameraModel()
            self.depth_keep_time = depth_keep_time
            self.depth_buffer = init_depth_buffer(
                depth_cameras, depth_buffer_depth, depth_max_points, 1, dev)
            self.depth_marking = init_marking_state(self.spec, self.params, g,
                                                    self._origin0)
            self._depth_max_points = depth_max_points

    # ------------------------------------------------------------------
    def push_depth_observation(self, cam_idx: int, cam_pos, cam_quat,
                               points, now):
        """Buffer one camera frame of world-frame points (`bufferCloud`),
        padded to the configured size."""
        pts = np.asarray(points, np.float32)[:self._depth_max_points]
        pad = np.zeros((1, self._depth_max_points, 3), np.float32)
        pad[0, :len(pts)] = pts
        mask = np.zeros((1, self._depth_max_points), bool)
        mask[0, :len(pts)] = True
        cp, cq, pad, mask, stamp = self._upload(
            np.reshape(cam_pos, (1, 3)), np.reshape(cam_quat, (1, 4)), pad,
            mask, np.float32(now))
        self.depth_buffer = push_observation(self.depth_buffer, cam_idx, cp,
                                             cq, pad, mask, stamp)

    def set_goal(self, goal_pos, now=0.0, goal_quat=None):
        self.driver.set_goal(goal_pos, now=now, goal_quat=goal_quat)

    def set_no_entry_enabled(self, enabled: bool):
        """The runtime zone toggle (`no_entry_layer.cpp` enable/disable)."""
        self.no_entry_enabled = enabled and self.no_entry_field is not None

    def clear_marking(self):
        """The `clear_perception_marking` service
        (`perception_3d_ros.cpp:276`)."""
        self.marking = init_marking_state(self.spec, self.params,
                                          len(self.ground), self._origin0)

    def note_odom(self, now):
        self.gate.update("odom", now=now)

    def close(self):
        self.driver.close()

    # -- checkpoint and resume -----------------------------------------
    def checkpoint_state(self) -> dict:
        """Every dynamic device state, as a dict of tensors and
        NamedTuples of tensors (restore with :meth:`restore_state`)."""
        state = {"marking": self.marking, "fsm": self.driver.fsm,
                 "dgraph": self.driver.dgraph}
        if self.n_depth_cameras > 0:
            state["depth_marking"] = self.depth_marking
            state["depth_buffer"] = self.depth_buffer
        return state

    def restore_state(self, state: dict):
        """Put back a :meth:`checkpoint_state`, or the fuller state of
        ``interop.port_session_state`` (which also carries the adopted
        plan, the recovery, the DWA cache and the host timers)."""
        self.marking = state["marking"]
        self.driver.fsm = state["fsm"]
        self.driver.decision = type(self.driver.decision)(
            int(state["fsm"].decision[0]))
        self.driver.dgraph = state["dgraph"]
        if self.n_depth_cameras > 0 and "depth_marking" in state:
            self.depth_marking = state["depth_marking"]
            self.depth_buffer = state["depth_buffer"]
        host = state.get("host")
        if host is None:
            return
        d, pm = self.driver, self.driver.plan_manager
        dwa = pm.dwa
        plan = host["plan"]
        d.plan = None if plan is None else make_global_plan(
            plan.positions[None], plan.quats[None],
            max_len=self.cfg.local_planner.max_plan_len, device=self.device)
        d.recovery = host["recovery"]
        d.recovery_succeed = host["recovery_succeed"]
        pm._plan, pm._fresh = host["pm_plan"], host["pm_fresh"]
        pm._empty_result = host["pm_empty_result"]
        pm._last_query_t = host["pm_last_query_t"]
        pm.active = host["pm_active"]
        dwa.current_goal = host["dwa_current_goal"]
        dwa.global_path = host["dwa_global_path"]
        dwa.dwa_path = host["dwa_path"]
        dwa.threading_active = host["dwa_threading_active"]
        dwa.last_recompute_t = host["dwa_last_recompute_t"]
        self._last_perception_t = host["last_perception_t"]
        self.gate._last = dict(host["gate_last"])

    def _upload(self, *arrays):
        """Host arrays on the device through one copy (each copy from
        pageable memory is a host sync): as f32 in their shapes, bool
        arrays back as bool."""
        flat = [np.asarray(a, np.float32).ravel() for a in arrays]
        buf = torch.as_tensor(np.concatenate(flat), device=self.device)
        out, i = [], 0
        for a, f in zip(arrays, flat):
            t = buf[i:i + f.size].view(np.shape(a))
            out.append(t > 0.5 if np.asarray(a).dtype == bool else t)
            i += f.size
        return out

    # ------------------------------------------------------------------
    def _observation(self, scan_global: np.ndarray):
        """The aggregated observation: the voxel-downsampled transformed
        scan (`multilayer_spinning_lidar.cpp:264-269`), padded to the
        critics' shape (1, k)."""
        k = self.cfg.local_planner.max_obstacle_points
        pts = (voxel_downsample(scan_global, 0.1) if len(scan_global)
               else scan_global)
        if len(pts) > k:
            stride = int(np.ceil(len(pts) / k))
            pts = pts[::stride][:k]
        obs = np.zeros((1, k, 3), np.float32)
        obs[0, :len(pts)] = pts
        mask = np.zeros((1, k), bool)
        mask[0, :len(pts)] = True
        return obs, mask

    def tick(self, scan_pts, scan_mask, robot_pos, robot_quat, v, w, now,
             tf_age: float = 0.0, scan_is_global: bool = False):
        """One 10 Hz cycle of the whole vertical.

        scan_pts/scan_mask: the live sweep in the sensor frame (robot frame
        plus ``sensor_offset``), or the global frame with
        ``scan_is_global``; a scan of fewer than 5 points is a missed scan
        (the freshness gate decays toward PERCEPTION_MALFUNCTION). tf_age:
        seconds since the localization TF was updated (> 2 s ⇒ TF_FAIL).
        Returns (vx, wz, decision, done, succeeded)."""
        with tracing.span("tick"):
            return self._tick(scan_pts, scan_mask, robot_pos, robot_quat, v,
                              w, now, tf_age, scan_is_global)

    def _tick(self, scan_pts, scan_mask, robot_pos, robot_quat, v, w, now,
              tf_age, scan_is_global):
        dev = self.device
        tracing.stage("perception")
        robot_pos = np.asarray(robot_pos, np.float32)
        robot_quat = np.asarray(robot_quat, np.float32)
        scan_pts = np.asarray(scan_pts, np.float32)
        scan_mask = np.asarray(scan_mask, bool)

        # the scan transform on the host, as the JAX session computes it
        quat_h = torch.from_numpy(robot_quat)
        sensor_pos = robot_pos + quat_rotate(
            quat_h, torch.from_numpy(self.sensor_offset)).numpy()
        if scan_is_global:
            scan_global = scan_pts
        else:
            # optional stitcher_num sweep accumulation in the sensor frame
            # (`multilayer_spinning_lidar.cpp:177-201`)
            scan_pts, scan_mask = self.stitcher.push(scan_pts, scan_mask)
            scan_global = quat_rotate(
                quat_h[None, :], torch.from_numpy(scan_pts)
            ).numpy() + sensor_pos[None, :]

        fresh_scan = bool(scan_mask.sum() >= 5)
        if fresh_scan:
            self.gate.update("scan", now=now)
        self.note_odom(now)

        p = self.cfg.perception
        obs, obs_mask = self._observation(
            scan_global[scan_mask] if len(scan_global) else scan_global)
        pos_t, quat_t, sensor_t, scan_t, mask_t, obs, obs_mask = self._upload(
            robot_pos[None], robot_quat[None], sensor_pos[None],
            scan_global[None], scan_mask[None], obs, obs_mask)
        if (fresh_scan and now - self._last_perception_t
                >= 1.0 / p.sensors_collected_frequency):
            self._last_perception_t = now
            self.marking = perception_update(
                self.spec, self.ri_spec, self.params, self.marking,
                self.map_ctx, scan_t, mask_t, pos_t, quat_t, sensor_t,
                quat_t)

        fields = [self.static_dgraph, self.marking.dgraph]
        if self.n_depth_cameras > 0:
            tracing.stage("depth")
            self.depth_marking, _ = depth_layer_update(
                self.spec, self.params, self.depth_cam, self.depth_marking,
                self.depth_buffer, torch.full((), now, device=dev),
                self.depth_keep_time, self.map_ctx, pos_t, quat_t)
            fields.append(self.depth_marking.dgraph)

        tracing.stage("composition+lethal")
        if self.no_entry_enabled:
            fields.append(self.no_entry_field)
        self.composed_dgraph = min_dgraph(*fields)[0]
        lethal_pts, lethal_valid = lethal_cloud_from_dgraph(
            self.ground_dev, self.ground_valid, self.composed_dgraph[None],
            inscribed_radius=p.inscribed_radius,
            max_lethal=self.cfg.global_planner.max_lethal_points)
        self.lethal = (lethal_pts[0], lethal_valid[0])
        self.driver.set_dgraph(self.composed_dgraph)
        self.driver.set_lethal(*self.lethal)

        cap = -1.0
        if self.speed_pts is not None:
            cap = speed_limit_at(pos_t, self.speed_pts, self.speed_valid,
                                 self.speed_val)

        return self.driver.tick(robot_pos, quat_t, v, w, obs, obs_mask, now,
                                sensor_ok=self.gate.ok(now=now),
                                tf_ok=tf_age <= 2.0, allowed_max_speed=cap)
