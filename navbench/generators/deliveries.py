"""The ``deliveries`` generator: one robot's closed delivery tour between
two docks, with its lidar sweeps and depth-camera frames, made from
``--seed`` in set-up.

The configuration names the two docks and the cameras. Each seed jitters
both docks within ``deliveries["jitter"]`` metres (the dock is then the
free ground node nearest the drawn point), draws a constant speed in
``deliveries["speed"]`` and puts ``clutter["count"]`` boxes beside the
tour, clear of it (``tours``' ``_beside``). The tour drives the shortest
free ground path from dock A to dock B, dwells there, drives back and
dwells at A, ``period_ticks`` ticks in all: a speed too slow to close the
tour with ``deliveries["min_dwell_s"]`` at each dock is raised to the
least that does. The goal is the dock the tour drives to and changes on
arrival; while the robot dwells, it turns toward its way out.

Ground nodes near the configuration's no-entry rectangle are not free, so
the tour keeps out of it as the planner does. Each tick's sweep is cast
through the map's boxes and the clutter, and each camera's frame is cast
into the same world from the camera's pose, kept inside its frustum and
above the floor, and thinned to at most ``max_points`` points. Sweeps and
frames are host arrays, as a ROS callback hands them to the session. None
of it depends on the commands the program returns, so the parent and a
change see the same inputs tick for tick.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from navbench import raycast
from navbench.generators import tours
from navbench.reference.perception import depth_camera

_AHEAD = 0.3          # metres along the way that set the heading


class Deliveries(NamedTuple):
    """A cell's inputs over the period (P ticks), host arrays."""
    pos: np.ndarray            # (P, 3) true base pose
    quat: np.ndarray           # (P, 4)
    v: np.ndarray              # (P,) true twist
    w: np.ndarray              # (P,)
    goals: np.ndarray          # (P, 3) the dock driven to
    scans: np.ndarray          # (P, N, 3) sweeps, sensor frame
    masks: np.ndarray          # (P, N)
    cam_pos: np.ndarray        # (P, C, 3) each camera's pose
    cam_quat: np.ndarray       # (P, C, 4)
    depth_pts: np.ndarray      # (P, C, D, 3) world points, padded
    depth_n: np.ndarray        # (P, C) points of each frame
    docks: np.ndarray          # (2, 3) the jittered docks
    clutter: np.ndarray        # (K, 2, 3) boxes beside the tour
    speed: np.ndarray          # () m/s

    @property
    def period(self) -> int:
        return self.pos.shape[0]


def grid_points(x0, x1, y0, y1, step):
    """Points on a ``step`` grid over [x0, x1] × [y0, y1] at z = 0."""
    xs = np.arange(x0, x1 + 1e-6, step)
    ys = np.arange(y0, y1 + 1e-6, step)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)],
                    1).astype(np.float32)


def _near_rect(ground, rect, clearance):
    x0, x1, y0, y1 = rect
    gap = np.maximum(np.maximum(np.asarray([x0, y0]) - ground[:, :2],
                                ground[:, :2] - np.asarray([x1, y1])), 0.0)
    return np.hypot(gap[:, 0], gap[:, 1]) <= clearance


def _docks(rng, ground, part, docks, jitter):
    """The free node nearest each dock moved by a seeded offset within
    ``jitter`` metres."""
    out = []
    free = np.flatnonzero(part)
    for d in np.asarray(docks, np.float64):
        r, a = jitter * np.sqrt(rng.random()), 2 * np.pi * rng.random()
        p = d[:2] + r * np.asarray([np.cos(a), np.sin(a)])
        out.append(free[np.argmin(np.linalg.norm(ground[free, :2] - p,
                                                 axis=1))])
    return out


def _timeline(legs, speed, period, dt):
    """Per tick: (leg the pose lies on, arc length along it, the leg the
    heading looks along, arc of the heading, moving, goal dock index).
    Leg 0 runs A → B, leg 1 B → A; each arrival starts a dwell."""
    total = period * dt
    lengths = [leg[-1] for leg in legs]
    dwell = (total - sum(lengths) / speed) / 2
    t = np.arange(period) * dt
    t_b = lengths[0] / speed                  # arrival at B
    t_back = t_b + dwell                      # leaving B
    t_a = t_back + lengths[1] / speed         # arrival at A
    rows = []
    for x in t:
        if x < t_b:
            rows.append((0, speed * x, 0, speed * x, True, 1))
        elif x < t_back:
            rows.append((0, lengths[0], 1, 0.0, False, 0))
        elif x < t_a:
            u = speed * (x - t_back)
            rows.append((1, u, 1, u, True, 0))
        else:
            rows.append((1, lengths[1], 0, 0.0, False, 1))
    return rows


def _at(leg_pts, cum, u):
    """The point at arc length ``u`` (clipped) of an open polyline."""
    u = min(max(u, 0.0), cum[-1])
    k = min(np.searchsorted(cum, u, side="right") - 1, len(leg_pts) - 2)
    f = (u - cum[k]) / max(cum[k + 1] - cum[k], 1e-9)
    return leg_pts[k] + f * (leg_pts[k + 1] - leg_pts[k])


def tour(world, config: dict, p: dict, rng):
    """The period's poses: (pos (P, 3), yaw (P,), v (P,), w (P,), goals
    (P, 3), docks (2, 3), speed)."""
    r, d = p["routes"], p["deliveries"]
    period, dt = p["period_ticks"], config["dt"]
    ground = world.ground
    floor = tours._Floor(world, r)
    keep_out = config["zones"]["no_entry"]["rect"]
    part = floor.largest(floor.free & ~_near_rect(ground, keep_out,
                                                  r["clearance"]))
    a, b = _docks(rng, ground, part, config["docks"], d["jitter"])
    paths = tours._Paths(floor.graph(part))
    legs = []
    for s, e in ((a, b), (b, a)):
        nodes, _ = paths(s, e)
        if nodes is None:
            raise RuntimeError("the docks are not joined by free ground")
        pts = ground[nodes].astype(np.float64)
        cum = np.concatenate([[0.0], np.cumsum(np.linalg.norm(
            np.diff(pts, axis=0), axis=1))])
        legs.append((pts, cum))
    lengths = sum(cum[-1] for _, cum in legs)
    speed = d["speed"][0] + rng.random() * (d["speed"][1] - d["speed"][0])
    speed = max(speed, lengths / (period * dt - 2 * d["min_dwell_s"]))
    rows = _timeline([cum for _, cum in legs], speed, period, dt)
    pos = np.zeros((period, 3))
    heading = np.zeros(period)
    goals = np.zeros((period, 3))
    v = np.zeros(period)
    for i, (leg, u, look, lu, moving, goal) in enumerate(rows):
        pos[i] = _at(*legs[leg], u)
        ahead = _at(*legs[look], lu + _AHEAD) - _at(*legs[look], lu)
        heading[i] = np.arctan2(ahead[1], ahead[0])
        goals[i] = ground[(a, b)[goal]]
        v[i] = speed if moving else 0.0
    yaw = tours._turning(heading, r["max_yaw_rate"] * dt)
    w = np.angle(np.exp(1j * (np.roll(yaw, -1) - yaw))) / dt
    return pos, yaw, v, w, goals, ground[[a, b]], speed


def frames(pos, yaw, boxes, cams: dict, device):
    """Every tick's frame of every camera: (cam_pos (P, C, 3), cam_quat
    (P, C, 4), points (P, C, D, 3) in the world frame, counts (P, C)),
    cast on ``device`` a batch of poses at a time."""
    cam = depth_camera.CameraModel()
    period, c = pos.shape[0], len(cams["yaws"])
    off = torch.as_tensor(cams["offset"], dtype=torch.float32, device=device)
    yaw = yaw.double()
    ca, sa = torch.cos(yaw).float(), torch.sin(yaw).float()
    cam_pos = pos + torch.stack([ca * off[0] - sa * off[1],
                                 sa * off[0] + ca * off[1],
                                 torch.full_like(ca, float(off[2]))], -1)
    cam_pos = cam_pos[:, None].expand(period, c, 3).reshape(-1, 3)
    cam_yaw = (yaw[:, None] + torch.as_tensor(cams["yaws"], dtype=torch.float64,
                                              device=device)).float()
    cam_yaw = cam_yaw.reshape(-1)
    quat = tours._yaw_quat(cam_yaw)
    n_max = cams["max_points"]
    rays = cams["rings"] * cams["cols"]
    chunk = max(1, raycast.RAYS_PER_PASS // rays)
    out_pts, out_n = [], []
    for f0 in range(0, cam_pos.shape[0], chunk):
        cp, cy, cq = (cam_pos[f0:f0 + chunk], cam_yaw[f0:f0 + chunk],
                      quat[f0:f0 + chunk])
        pts, z, hit = raycast.cast(cp, cy, cams["rings"], cams["cols"],
                                   cams["v_bottom"], cams["v_top"],
                                   cam.max_detect_distance, boxes)
        c_, s_ = torch.cos(cy)[:, None], torch.sin(cy)[:, None]
        world = torch.stack([c_ * pts[..., 0] - s_ * pts[..., 1],
                             s_ * pts[..., 0] + c_ * pts[..., 1],
                             pts[..., 2]], -1) + cp[:, None]
        normals, planes = depth_camera.frustum_planes(cam, cp, cq)
        keep = (hit & (z >= cams["floor_clearance"])
                & depth_camera.in_frustum(normals[:, None], planes[:, None],
                                          world))
        # every k-th return, k the least that keeps at most n_max
        n = keep.sum(1)
        k = torch.clamp((n + n_max - 1) // n_max, min=1)
        rank = torch.cumsum(keep.long(), 1) - 1
        keep = keep & (rank % k[:, None] == 0)
        slot = torch.where(keep, rank // k[:, None], n_max)
        pad = torch.zeros((cp.shape[0], n_max + 1, 3), device=device)
        pad.scatter_(1, slot[..., None].expand(-1, -1, 3), world)
        out_pts.append(pad[:, :n_max])
        out_n.append(keep.sum(1))
    pts = torch.cat(out_pts).reshape(period, c, n_max, 3)
    return (cam_pos.reshape(period, c, 3), quat.reshape(period, c, 4), pts,
            torch.cat(out_n).reshape(period, c))


def generate(world, config: dict, p: dict, seed: int, device) -> Deliveries:
    """A cell's traffic for ``seed``: the tour, the clutter and the docks'
    jitter from a NumPy generator seeded with ``seed``; sweeps and frames
    cast on ``device`` and handed back as host arrays."""
    rng = np.random.default_rng(seed)
    pos, yaw, v, w, goals, docks, speed = tour(world, config, p, rng)
    clutter = tours._beside(rng, pos[:, None], yaw[:, None], world,
                            {"clutter": {**p["clutter"],
                                         "beside_route": p["clutter"]["count"]},
                             "routes": p["routes"]})

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    pos_t, yaw_t = f32(pos), f32(yaw)
    scans, masks = tours.sweeps(pos_t[:, None], yaw_t[:, None], None, clutter,
                                world, config["sensor"])
    boxes = torch.as_tensor(np.concatenate([world.boxes, clutter]),
                            device=device)
    cam_pos, cam_quat, depth_pts, depth_n = frames(pos_t, yaw_t, boxes,
                                                   config["cameras"], device)

    def host(x):
        return x.cpu().numpy()
    return Deliveries(
        pos=pos.astype(np.float32), quat=host(tours._yaw_quat(yaw_t)),
        v=v.astype(np.float32), w=w.astype(np.float32),
        goals=goals.astype(np.float32), scans=host(scans[:, 0]),
        masks=host(masks[:, 0]), cam_pos=host(cam_pos),
        cam_quat=host(cam_quat), depth_pts=host(depth_pts),
        depth_n=host(depth_n), docks=docks.astype(np.float32),
        clutter=clutter, speed=np.asarray(speed, np.float32))
