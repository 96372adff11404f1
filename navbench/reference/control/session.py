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

Everything a tick changes is one tree, :class:`SessionState` (the
driver's, plan manager's and DWA manager's parts are the NamedTuples of
their modules). :meth:`NavigationSession.step` is the tick as a function
of (state, :class:`SessionInputs`): it loads the state, writing into none
of its tensors and adding no host-device copy, runs the tick and returns
the new state with the tick's answer, a :class:`SessionOut`.
:meth:`NavigationSession.tick` runs the same tick on the session's own
state and returns host values.

The device state is batched with B = 1. Rounding follows the JAX call
sites: the scan transform, ``speed_limit_at`` and ``no_entry_dgraph`` run
eagerly there, so the port uses their plain forms; the perception, depth
and lethal-cloud stages are jitted there, and the port's functions round
as those programs do. A :class:`SessionOut`'s diag carries the lethal
nodes before and after the ``max_lethal_points`` cap (``lethal_seen`` /
``lethal_kept``) and the LOS gate's long edges before and after its cap in
one gate run (``los_edges_seen`` / ``los_edges_kept``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from navbench.reference.config import NavigationConfig
from navbench.reference.control.fused import _specs
from navbench.reference.control.move_base import (
    DriveOut, DriverState, MoveBaseDriver)
from navbench.reference.geometry import quat_rotate
from navbench.reference.io.maps import voxel_downsample
from navbench.reference.perception.depth_camera import (
    CameraModel, DepthCameraBuffer, depth_layer_update, init_depth_buffer,
    push_observation)
from navbench.reference.perception.layers import (
    min_dgraph, no_entry_dgraph, speed_limit_at)
from navbench.reference.perception.marking import (
    MarkingState, init_marking_state, perception_update)
from navbench.reference.perception.static_map import (
    build_map_context)
from navbench.reference.perception.stitcher import ScanStitcher
from navbench.reference.planning.global_.los import (
    lethal_cloud_from_dgraph)
from navbench.reference.runtime.watchdog import FreshnessGate


class SessionState(NamedTuple):
    """Everything a session tick changes. Host values are CPU tensors or
    Python scalars."""
    marking: MarkingState                # the lidar layer
    depth_marking: Optional[MarkingState]  # the depth layer (None: no
    depth_buffer: Optional[DepthCameraBuffer]  # cameras) and its rings
    composed: torch.Tensor               # (G,) the min-composed field
    driver: DriverState                  # FSM, field, lethal cloud, goal,
                                         # plan, recovery, plan manager
    last_perception_t: float             # the last mark/clear's clock
    scan_seen: Optional[float]           # the freshness gate's clocks
    odom_seen: Optional[float]
    stitched: tuple                      # the stitcher's ring, (n, 3) CPU
    no_entry_enabled: bool               # the no-entry layer's toggle


class SessionInputs(NamedTuple):
    """One tick's inputs, as host values (a ROS callback's messages)."""
    scan_pts: np.ndarray        # (N, 3) the live sweep, sensor frame
    scan_mask: np.ndarray       # (N,)
    robot_pos: np.ndarray       # (3,)
    robot_quat: np.ndarray      # (4,)
    v: float                    # the measured twist
    w: float
    now: float                  # s
    # per camera (cam_pos (3,), cam_quat (4,), world points (n, 3)), or
    # None: the frames buffered before the depth layer's update
    depth_frames: tuple = ()
    goal: Optional[np.ndarray] = None       # a new goal (3,), set first
    goal_quat: Optional[np.ndarray] = None  # (4,), identity by default
    tf_age: float = 0.0         # s since the localization TF was updated
    scan_is_global: bool = False


# A tick's answer: the driver's, its diag joined by the session's counters
# (``lethal_seen``, ``lethal_kept``, ``los_edges_seen``, ``los_edges_kept``).
SessionOut = DriveOut


class NavigationSession:
    """One robot's complete navigation vertical over a loaded map."""

    def __init__(self, cfg: NavigationConfig, ground: np.ndarray,
                 map_pts: Optional[np.ndarray] = None,
                 node_weight: Optional[np.ndarray] = None,
                 static_dgraph: Optional[np.ndarray] = None,
                 no_entry_zones: Optional[np.ndarray] = None,
                 speed_zones: Optional[tuple] = None,
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
            device=dev)
        self.sensor_offset = np.asarray(sensor_offset, np.float32)
        self.gate = FreshnessGate(expected_dt={
            "scan": max(2.0 / p.sensors_collected_frequency,
                        2.0 * p.lidar.expected_sensor_time),
            "odom": 0.5,
        })
        self._last_perception_t = -1e9
        self.composed_dgraph = self.static_dgraph
        # no lethal point before the first tick composes the field
        n = cfg.global_planner.max_lethal_points
        self.lethal = (torch.full((n, 3), 1e6, device=dev),
                       torch.zeros((n,), dtype=torch.bool, device=dev))
        self.driver.set_lethal(*self.lethal)
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
        self._initial = self.state()

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

    # -- the state tree ------------------------------------------------
    def init_state(self) -> SessionState:
        """The state of the session as built: empty layers, no goal."""
        return self._initial

    def state(self) -> SessionState:
        """The session's :class:`SessionState` (its tensors, not copies)."""
        gate = self.gate._last
        depth = self.n_depth_cameras > 0
        return SessionState(
            marking=self.marking,
            depth_marking=self.depth_marking if depth else None,
            depth_buffer=self.depth_buffer if depth else None,
            composed=self.composed_dgraph, driver=self.driver.state(),
            last_perception_t=self._last_perception_t,
            scan_seen=gate.get("scan"), odom_seen=gate.get("odom"),
            stitched=self.stitcher.state(),
            no_entry_enabled=self.no_entry_enabled)

    def _load(self, s: SessionState):
        """Put back a :meth:`state`: attributes only, no copy."""
        self.marking = s.marking
        if self.n_depth_cameras > 0:
            self.depth_marking, self.depth_buffer = (s.depth_marking,
                                                     s.depth_buffer)
        self.composed_dgraph = s.composed
        self.driver.load(s.driver)
        self.lethal = (s.driver.lethal_pts, s.driver.lethal_valid)
        self._last_perception_t = s.last_perception_t
        self.gate._last = {k: v for k, v in (("scan", s.scan_seen),
                                             ("odom", s.odom_seen))
                           if v is not None}
        self.stitcher.load(s.stitched)
        self.no_entry_enabled = s.no_entry_enabled

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
        """One 10 Hz cycle of the whole vertical, on the session's own state
        (:meth:`step`'s tick without the load and the store).

        scan_pts/scan_mask: the live sweep in the sensor frame (robot frame
        plus ``sensor_offset``), or the global frame with
        ``scan_is_global``; a scan of fewer than 5 points is a missed scan
        (the freshness gate decays toward PERCEPTION_MALFUNCTION). tf_age:
        seconds since the localization TF was updated (> 2 s ⇒ TF_FAIL).
        Returns (vx, wz, decision, done, succeeded)."""
        out = self._tick(SessionInputs(
            scan_pts, scan_mask, robot_pos, robot_quat, v, w, now,
            tf_age=tf_age, scan_is_global=scan_is_global))
        return out.vx, out.wz, out.decision, out.done, out.succeeded

    def step(self, state: SessionState, inputs: SessionInputs
             ) -> tuple[SessionState, SessionOut]:
        """The tick as a function of (state, inputs): loads ``state``, sets
        the inputs' new goal, buffers their depth frames, ticks, and
        returns (the new state, the tick's answer). The tensors of
        ``state`` are read, never written; loading it makes no host-device
        copy and no sync."""
        self._load(state)
        if inputs.goal is not None:
            self.set_goal(inputs.goal, now=inputs.now,
                          goal_quat=inputs.goal_quat)
        out = self._tick(inputs)
        return self.state(), out

    def _tick(self, x: SessionInputs) -> SessionOut:
        robot_pos = np.asarray(x.robot_pos, np.float32)
        pos_t, quat_t, obs, obs_mask = self._perceive(
            np.asarray(x.scan_pts, np.float32), np.asarray(x.scan_mask, bool),
            robot_pos, np.asarray(x.robot_quat, np.float32), x.now,
            x.scan_is_global)

        fields = [self.static_dgraph, self.marking.dgraph]
        if self.n_depth_cameras > 0:
            fields.append(self._depth(x.depth_frames, x.now, pos_t,
                                      quat_t).dgraph)

        counts = self._compose(fields)

        cap = -1.0
        if self.speed_pts is not None:
            cap = speed_limit_at(pos_t, self.speed_pts, self.speed_valid,
                                 self.speed_val)

        out = self.driver.drive(robot_pos, quat_t, x.v, x.w, obs, obs_mask,
                                x.now, sensor_ok=self.gate.ok(now=x.now),
                                tf_ok=x.tf_age <= 2.0, allowed_max_speed=cap)
        return out._replace(diag={**out.diag, **counts})

    def _perceive(self, scan_pts, scan_mask, robot_pos, robot_quat, now,
                  scan_is_global):
        """The lidar layer: the scan transform and the observation on the
        host, their upload, and mark/clear at
        ``sensors_collected_frequency``. Returns the device's (robot pos
        (1, 3), robot quat (1, 4), observation (1, k, 3), its mask)."""
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
        return pos_t, quat_t, obs, obs_mask

    def _depth(self, frames, now, pos_t, quat_t) -> MarkingState:
        """The depth-camera layer: buffer the frames, then clear against
        every live buffered frustum and mark the latest frames."""
        for c, frame in enumerate(frames):
            if frame is not None:
                self.push_depth_observation(c, *frame, now)
        self.depth_marking, _ = depth_layer_update(
            self.spec, self.params, self.depth_cam, self.depth_marking,
            self.depth_buffer, torch.full((), now, device=self.device),
            self.depth_keep_time, self.map_ctx, pos_t, quat_t)
        return self.depth_marking

    def _compose(self, fields: list) -> dict:
        """The min-composed field (with the no-entry layer under its
        toggle) and the lethal cloud, handed to the driver. Returns the
        lethal and LOS counters as device tensors."""
        p = self.cfg.perception
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
        seen = (self.ground_valid
                & (self.composed_dgraph <= p.inscribed_radius)).sum()
        kept = lethal_valid.sum()
        los_seen, los_kept = self.driver.runtime.los_counts
        return {"lethal_seen": seen, "lethal_kept": kept,
                "los_edges_seen": los_seen, "los_edges_kept": los_kept}
