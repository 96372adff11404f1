"""Drives one robot's navigation session through
``control/session.py::NavigationSession.step``: the lidar and depth-camera
layers, the no-entry and speed-limit zones, the lethal cloud, the plan
manager's LOS-gated queries with the DWA windowed replan, the local tick,
the move-base FSM and its rotate recovery.

The same code builds the program (``dddmr_navigation_tpu_torch``) and the
reference (``navbench.reference``): each builds its own session (ground
graph, turning tables, zone fields) from the benchmark's world, thinned
where the configuration's map is sparse (:func:`map_ground`), and the
configuration's zones. The session's ``step`` is a function of (state,
inputs): the session object holds what no tick changes and is loaded from
the state tree each tick. Each tick the benchmark hands the session the
tour's true pose and twist, sweep and camera frames as host arrays (as a
ROS callback would), and a new goal when the tour reaches its dock.
"""
from __future__ import annotations

import importlib

import numpy as np

from navbench.generators.deliveries import grid_points
from navbench.spec import build_dataclass


# The modules of a side that the deployment calls.
MODULES = ("config", "control.session", "perception.depth_camera")


def zones(config: dict):
    """(no-entry zone points (Z, 3), (speed-zone points (S, 3), their
    speeds (S,))): the no-entry rectangle on its grid, and every point of
    the speed zone's grid within its radius of a dock."""
    ne = config["zones"]["no_entry"]
    no_entry = grid_points(*ne["rect"], ne["step"])
    sp = config["zones"]["speed"]
    pts = []
    for dock in np.asarray(config["docks"], np.float32):
        r = sp["radius"]
        g = grid_points(dock[0] - r, dock[0] + r, dock[1] - r, dock[1] + r,
                        sp["step"])
        pts.append(g[np.hypot(g[:, 0] - dock[0], g[:, 1] - dock[1]) <= r])
    pts = np.concatenate(pts)
    return no_entry, (pts, np.full((len(pts),), sp["speed"], np.float32))


def map_ground(world, config: dict) -> np.ndarray:
    """The ground nodes of the session's map: the world's floor, except in
    ``config["sparse_ground"]["rect"]``, where the mapping run left a node
    only every ``step`` metres (a stretch of floor it saw from afar). Those
    nodes fall to the planner's kNN fallback, and their edges that reach 2
    × the inscribed radius are the long edges the LOS gate checks. The
    floor the robot drives and the lidar sees stays whole."""
    sparse = config["sparse_ground"]
    x0, x1, y0, y1 = sparse["rect"]
    g = world.ground
    inside = ((g[:, 0] >= x0) & (g[:, 0] <= x1)
              & (g[:, 1] >= y0) & (g[:, 1] <= y1))
    return np.concatenate([g[~inside],
                           grid_points(x0, x1, y0, y1, sparse["step"])])


class Built:
    """One side's session (what no tick changes) and its start state."""

    def __init__(self, pkg: str, config: dict, world, traffic, device):
        self.pkg = pkg
        self.mods = {m: importlib.import_module(f"{pkg}.{m}")
                     for m in MODULES}
        c = self.mods["config"]
        session = self.mods["control.session"]
        self.cfg = build_dataclass(c.NavigationConfig(), config["navigation"])
        cams = config["cameras"]
        no_entry, speed = zones(config)
        self.session = session.NavigationSession(
            self.cfg, map_ground(world, config), no_entry_zones=no_entry,
            speed_zones=speed, sensor_offset=config["sensor"]["offset"],
            depth_cameras=len(cams["yaws"]),
            depth_camera_model=self.mods[
                "perception.depth_camera"].CameraModel(),
            depth_buffer_depth=cams["buffer_depth"],
            depth_max_points=cams["max_points"],
            depth_keep_time=cams["keep_time"], device=device)
        self.inputs_type = session.SessionInputs
        self.dt = config["dt"]
        self.traffic = traffic
        self.state0 = self.session.init_state()


def inputs(b: Built, t: int):
    """Tick ``t``'s SessionInputs: the tour's pose, twist, sweep and
    frames, and its dock as a new goal on tick 0 and on each arrival (the
    tick whose dock is not the last tick's)."""
    tr = b.traffic
    p = t % tr.period
    goal = tr.goals[p]
    new = t == 0 or not np.array_equal(goal, tr.goals[(t - 1) % tr.period])
    frames = tuple((tr.cam_pos[p, c], tr.cam_quat[p, c],
                    tr.depth_pts[p, c, :tr.depth_n[p, c]])
                   for c in range(tr.cam_pos.shape[1]))
    return b.inputs_type(
        scan_pts=tr.scans[p], scan_mask=tr.masks[p], robot_pos=tr.pos[p],
        robot_quat=tr.quat[p], v=float(tr.v[p]), w=float(tr.w[p]),
        now=t * b.dt, depth_frames=frames, goal=goal if new else None)


def tick(b: Built, state, t: int):
    """Tick ``t`` from ``state``. Returns (state, record): the record's
    ``out`` is the tick's SessionOut, ``cmd`` its (1, 2) command. The step
    is looked up on its class at each call, so a wrapper put there (a
    fault in a test) is the one that runs."""
    state2, out = b.session.step(state, inputs(b, t))
    return state2, {"out": out, "cmd": out.cmd}
