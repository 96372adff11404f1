"""The ``tours`` generator: a cell's inputs, made from ``--seed`` in
set-up, from the parameters of its traffic file.

Each robot drives a closed tour of seeded goals over the configuration's
ground graph, around seeded clutter boxes (and past boxes put beside
the tours, ``beside_route``), at the constant speed that
closes the tour in ``period_ticks`` ticks; tick t of a run takes tick
t mod ``period_ticks`` of the tour, so the inputs never run out and never
jump. The benchmark owns the world: each tick hands the program the true
pose and twist on the tour, the goal the robot is driving to (the next
one on arrival), the sweep ray-cast from that pose (through the clutter,
the static boxes and, with ``bodies``, the other robots at that tick),
the odometry drift and the MCL draws. None of it depends on the commands
the program returns, so the parent and a change see the same inputs tick
for tick. ``clutter`` and ``bodies`` may be null: no boxes besides the
map's, and sweeps that meet only the map.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from navbench import raycast

_HEAD = 0.3          # metres ahead and behind that set a tour's heading
_POCKET = 8          # free nodes a clutter box may cut off besides its own
CLOCK_TICKS = 1 << 16   # ticks of the clock handed to the program


class Traffic(NamedTuple):
    """A cell's inputs on the device, (P, B, ...) over the period."""
    pos: torch.Tensor          # (P, B, 3) true base pose
    quat: torch.Tensor         # (P, B, 4)
    v: torch.Tensor            # (P, B) true twist
    w: torch.Tensor            # (P, B)
    goals: torch.Tensor        # (P, B, 3) the goal driven to
    scans: torch.Tensor        # (P, B, N, 3) sweeps, sensor frame
    masks: torch.Tensor        # (P, B, N)
    drift_pos: torch.Tensor    # (P, B, 3) odometry drift
    drift_yaw: torch.Tensor    # (P, B)
    now: torch.Tensor          # (CLOCK_TICKS,) clock, s: t·dt at tick t
    dt: torch.Tensor           # () f32
    draws: dict                # MCL draws, {field: (P, B, ...)}, or empty
    init_normals: tuple        # MCL start normals, two (B, N, 3), or ()
    clutter: np.ndarray        # (K, 2, 3) clutter boxes
    speeds: np.ndarray         # (B,) tour speeds, m/s

    @property
    def period(self) -> int:
        return self.pos.shape[0]


class _Floor:
    """The ground nodes a robot body may stand on, and the graph of steps
    between them (nodes within ``edge`` of each other, |dz| ≤ 0.2 m)."""

    def __init__(self, world, r: dict):
        from scipy.spatial import cKDTree
        self.ground, self.clearance = world.ground, r["clearance"]
        pairs = cKDTree(self.ground).query_pairs(r["edge"],
                                                 output_type="ndarray")
        dz = np.abs(self.ground[pairs[:, 0], 2] - self.ground[pairs[:, 1], 2])
        self.pairs = pairs[dz <= 0.2]
        self.free = ~(_outside(self.ground, r["region"])
                      | _near_structure(self.ground, world.structure,
                                        self.clearance)
                      | _near_boxes(self.ground, world.boxes,
                                    self.clearance))
        self.on_floor = np.zeros(len(self.ground), bool)
        for z, (lo, hi) in zip(world.levels, world.regions):
            self.on_floor |= ((np.abs(self.ground[:, 2] - z) < 1e-3)
                              & (self.ground[:, :2] >= lo).all(1)
                              & (self.ground[:, :2] <= hi).all(1))
        self.levels = world.levels

    def graph(self, free):
        from scipy.sparse import coo_matrix
        p = self.pairs[free[self.pairs[:, 0]] & free[self.pairs[:, 1]]]
        d = np.linalg.norm(self.ground[p[:, 0]] - self.ground[p[:, 1]], axis=1)
        g = len(self.ground)
        return coo_matrix((np.concatenate([d, d]),
                           (np.concatenate([p[:, 0], p[:, 1]]),
                            np.concatenate([p[:, 1], p[:, 0]]))),
                          shape=(g, g)).tocsr()

    def largest(self, free):
        """The largest connected part of ``free``, as a mask."""
        from scipy.sparse.csgraph import connected_components
        _, part = connected_components(self.graph(free), directed=False)
        return free & (part == np.bincount(part[free]).argmax())

    def spans_levels(self, part) -> bool:
        z = self.ground[part & self.on_floor, 2]
        return all((np.abs(z - lv) < 1e-3).any() for lv in self.levels)


def _outside(ground, region):
    lo, hi = np.asarray(region, np.float32)
    return ((ground[:, :2] < lo) | (ground[:, :2] > hi)).any(axis=1)


def _near_structure(ground, structure, clearance):
    """Nodes within ``clearance`` (xy) of structure 0.1-1.5 m above them."""
    from scipy.spatial import cKDTree
    out = np.zeros(len(ground), bool)
    tree = cKDTree(structure[:, :2])
    for i, near in enumerate(tree.query_ball_point(ground[:, :2],
                                                   clearance)):
        if near:
            rel = structure[near, 2] - ground[i, 2]
            out[i] = bool(((rel > 0.1) & (rel < 1.5)).any())
    return out


def _near_boxes(ground, boxes, clearance):
    """Nodes within ``clearance`` (xy) of a box reaching 0.1-1.5 m above."""
    if not len(boxes):
        return np.zeros(len(ground), bool)
    bl, bh = boxes[:, 0], boxes[:, 1]                      # (S, 3)
    gx = ground[:, None, :2]
    gap = np.maximum(np.maximum(bl[None, :, :2] - gx,
                                gx - bh[None, :, :2]), 0.0)
    near = np.hypot(gap[..., 0], gap[..., 1]) <= clearance
    zlo, zhi = ground[:, None, 2] + 0.1, ground[:, None, 2] + 1.5
    overlap = (bh[None, :, 2] > zlo) & (bl[None, :, 2] < zhi)
    return (near & overlap).any(axis=1)


def _clutter(rng, p: dict, world, floor: _Floor):
    """Seeded clutter boxes, drawn one at a time on the levels' floors; a
    box that would cut the free floor apart (lose more than a few nodes
    besides its own, or a whole level) is drawn again. Returns (boxes
    (K, 2, 3), the largest free part left)."""
    part = floor.largest(floor.free)
    c = p.get("clutter")
    boxes = []
    for _ in range(20 * (c["count"] if c else 0)):
        if len(boxes) == c["count"]:
            break
        lv = rng.integers(len(world.levels))
        lo, hi = world.regions[lv]
        xy = lo + rng.random(2) * (hi - lo)
        size = c["size_xy"][0] + rng.random(2) * (c["size_xy"][1]
                                                  - c["size_xy"][0])
        h = c["height"][0] + rng.random() * (c["height"][1] - c["height"][0])
        z = world.levels[lv]
        box = np.asarray([[xy[0] - size[0] / 2, xy[1] - size[1] / 2, z],
                          [xy[0] + size[0] / 2, xy[1] + size[1] / 2, z + h]],
                         np.float32)
        hit = _near_boxes(floor.ground, box[None], floor.clearance)
        trial = floor.largest(part & ~hit)
        lost = int(part.sum()) - int(trial.sum()) - int((part & hit).sum())
        if lost <= _POCKET and floor.spans_levels(trial):
            boxes.append(box)
            part = trial
    return np.asarray(boxes, np.float32).reshape(-1, 2, 3), part


class _Paths:
    """Shortest paths on the route graph, one Dijkstra a source."""

    def __init__(self, graph):
        self.graph, self.cache = graph, {}

    def __call__(self, a: int, b: int):
        from scipy.sparse.csgraph import dijkstra
        if a not in self.cache:
            self.cache[a] = dijkstra(self.graph, indices=a,
                                     return_predecessors=True)
        dist, pred = self.cache[a]
        if not np.isfinite(dist[b]):
            return None, np.inf
        path = [b]
        while path[-1] != a:
            path.append(pred[path[-1]])
        return path[::-1], dist[b]


def _tour(rng, paths, goal_nodes, ground, p: dict, length: float):
    """A closed tour of seeded goals at least ``length`` metres long:
    (node path (M,), the goal node each path node drives to (M,))."""
    r = p["routes"]
    levels = np.round(ground[goal_nodes, 2], 2)
    first = goal_nodes[rng.integers(len(goal_nodes))]
    goals, nodes, targets, total = [first], [], [], 0.0
    while True:
        prev = goals[-1]
        for _ in range(200):
            cand = goal_nodes[rng.integers(len(goal_nodes))]
            far = (np.linalg.norm(ground[cand, :2] - ground[prev, :2])
                   >= r["min_goal_distance"])
            other = (not r.get("alternate_levels")
                     or levels[goal_nodes == cand][0]
                     != np.round(ground[prev, 2], 2))
            path, d = paths(prev, cand)
            if far and other and path is not None:
                break
        else:
            raise RuntimeError("no reachable goal for a tour")
        back, d_back = paths(cand, first)
        if back is None:
            continue
        nodes += path[:-1]
        targets += [cand] * (len(path) - 1)
        goals.append(cand)
        total += d
        if total + d_back >= length:
            nodes += back[:-1]
            targets += [first] * (len(back) - 1)
            return np.asarray(nodes), np.asarray(targets)


def _along(pts: np.ndarray, u: np.ndarray):
    """Points at arc lengths ``u`` (mod the closed length) of the closed
    polyline ``pts`` (M, 3), and the segment each falls in."""
    seg = np.linalg.norm(np.roll(pts, -1, axis=0) - pts, axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    u = np.mod(u, cum[-1])
    k = np.clip(np.searchsorted(cum, u, side="right") - 1, 0, len(pts) - 1)
    f = ((u - cum[k]) / np.maximum(seg[k], 1e-9))[:, None]
    return pts[k] + f * (np.roll(pts, -1, axis=0)[k] - pts[k]), k


def _turning(heading: np.ndarray, max_step: float) -> np.ndarray:
    """The yaw of a base that turns toward ``heading`` (P,) by at most
    ``max_step`` a tick, periodic over the period (the second of two laps,
    so the lap starts where it ends)."""
    yaw = heading[0]
    out = np.empty_like(heading)
    for lap in range(2):
        for t, h in enumerate(heading):
            err = np.angle(np.exp(1j * (h - yaw)))
            yaw = yaw + np.clip(err, -max_step, max_step)
            out[t] = yaw
    return np.angle(np.exp(1j * out))


def tours(world, p: dict, robots: int, period: int, dt: float, rng):
    """Every robot's tour, sampled at each tick of the period: (pos
    (P, B, 3), yaw (P, B), v (P, B), w (P, B), goals (P, B, 3), clutter,
    speeds)."""
    r = p["routes"]
    ground = world.ground
    floor = _Floor(world, r)
    clutter, part = _clutter(rng, p, world, floor)
    graph = floor.graph(part)
    goal_nodes = np.flatnonzero(part & floor.on_floor)
    paths = _Paths(graph)
    ticks = np.arange(period)
    pos = np.zeros((period, robots, 3))
    yaw = np.zeros((period, robots))
    goals = np.zeros((period, robots, 3))
    speeds = np.zeros(robots)
    for b in range(robots):
        target = r["speed"][0] + rng.random() * (r["speed"][1]
                                                 - r["speed"][0])
        nodes, to = _tour(rng, paths, goal_nodes, ground, p,
                          target * period * dt)
        pts = ground[nodes].astype(np.float64)
        length = np.linalg.norm(np.roll(pts, -1, 0) - pts, axis=1).sum()
        speeds[b] = length / (period * dt)
        u = ticks * (length / period)
        pos[:, b], k = _along(pts, u)
        goals[:, b] = ground[to[k]]
        ahead, _ = _along(pts, u + _HEAD)
        behind, _ = _along(pts, u - _HEAD)
        d = ahead - behind
        yaw[:, b] = _turning(np.arctan2(d[:, 1], d[:, 0]),
                             r["max_yaw_rate"] * dt)
    w = np.angle(np.exp(1j * (np.roll(yaw, -1, 0) - yaw))) / dt
    v = np.broadcast_to(speeds, (period, robots))
    return pos, yaw, v, w, goals, clutter, speeds


def _beside(rng, pos, yaw, world, p: dict) -> np.ndarray:
    """``clutter["beside_route"]`` boxes at seeded points of the tours,
    ``beside_offset`` metres to their left or right on the same floor,
    clear of every tour point by the route clearance."""
    c, clear = p["clutter"], p["routes"]["clearance"]
    want = c.get("beside_route", 0)
    period, robots = pos.shape[:2]
    flat = pos.reshape(-1, 3)
    boxes = []
    for _ in range(50 * want):
        if len(boxes) == want:
            break
        t, b = rng.integers(period), rng.integers(robots)
        side = rng.choice([-1.0, 1.0])
        off = c["beside_offset"][0] + rng.random() * (c["beside_offset"][1]
                                                      - c["beside_offset"][0])
        size = c["size_xy"][0] + rng.random(2) * (c["size_xy"][1]
                                                  - c["size_xy"][0])
        h = c["height"][0] + rng.random() * (c["height"][1] - c["height"][0])
        z = pos[t, b, 2]
        if min(abs(z - lv) for lv in world.levels) > 1e-3:
            continue                          # not on a floor (the ramp)
        normal = np.asarray([-np.sin(yaw[t, b]), np.cos(yaw[t, b])])
        center = pos[t, b, :2] + side * off * normal
        lo, hi = center - size / 2, center + size / 2
        near = np.abs(flat[:, 2] - z) < 0.5
        gap = np.maximum(np.maximum(lo - flat[near, :2],
                                    flat[near, :2] - hi), 0.0)
        if np.hypot(gap[:, 0], gap[:, 1]).min() <= clear:
            continue
        boxes.append([[lo[0], lo[1], z], [hi[0], hi[1], z + h]])
    return np.asarray(boxes, np.float32).reshape(-1, 2, 3)


def _periodic_walk(rng, shape, sigma: float) -> np.ndarray:
    """A random walk over axis 0 whose steps sum to nothing, so that it
    closes on itself over the period."""
    inc = rng.normal(0.0, sigma, size=shape)
    inc -= inc.mean(axis=0, keepdims=True)
    return np.cumsum(inc, axis=0)


def _yaw_quat(yaw: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(yaw)
    return torch.stack([z, z, torch.sin(yaw / 2), torch.cos(yaw / 2)], -1)


def sweeps(pos, yaw, bodies, clutter, world, sensor: dict):
    """Every tick's sweep of every robot, cast on the device a few ticks
    at a time (:data:`raycast.RAYS_PER_PASS` rays a pass): (scans (P, B, N, 3), masks (P, B, N)). Returns below
    ``ground_clearance`` above the robot's floor are masked (the ground
    segmentation a deployment runs)."""
    dev = pos.device
    period, b = pos.shape[:2]
    static = torch.as_tensor(np.concatenate([world.boxes, clutter]),
                             device=dev)
    offset = torch.as_tensor(sensor["offset"], dtype=torch.float32,
                             device=dev)
    chunk = max(1, raycast.RAYS_PER_PASS
                // (b * sensor["rings"] * sensor["cols"]))
    scans, masks = [], []
    for t0 in range(0, period, chunk):
        p = pos[t0:t0 + chunk]
        n = p.shape[0]
        own = None
        if bodies is not None:
            half = torch.as_tensor([bodies[0] / 2, bodies[1] / 2, 0.0],
                                   device=dev)
            top = torch.as_tensor([bodies[0] / 2, bodies[1] / 2, bodies[2]],
                                  device=dev)
            lo = (p - half)[:, None].expand(n, b, b, 3)     # (n, i, j, 3)
            hi = (p + top)[:, None].expand(n, b, b, 3)
            eye = torch.eye(b, dtype=torch.bool, device=dev)[None, :, :, None]
            hi = torch.where(eye, lo, hi)                   # no own body
            own = torch.stack([lo, hi], dim=3).reshape(n * b, b, 2, 3)
        pts, z, mask = raycast.cast(
            (p + offset).reshape(-1, 3), yaw[t0:t0 + chunk].reshape(-1),
            sensor["rings"], sensor["cols"], sensor["v_bottom"],
            sensor["v_top"], sensor["max_range"], static, own)
        floor = p[..., 2].reshape(-1, 1)
        mask = mask & (z >= floor + sensor["ground_clearance"])
        scans.append(torch.where(mask[..., None], pts, 0.0).reshape(
            n, b, -1, 3))
        masks.append(mask.reshape(n, b, -1))
    return torch.cat(scans), torch.cat(masks)


def mcl_draws(gen, period: int, b: int, n: int, device) -> dict:
    """Every tick's MCL draws (the fields of the port's ``pf.MCLDraws``),
    made on the device in one call a field."""
    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)
    return dict(resample_u=torch.rand((period, b), generator=gen,
                                      device=device),
                resample_pos=normal(period, b, n, 3),
                resample_rpy=normal(period, b, n, 3),
                expand_pos=normal(period, b, n, 3),
                expand_rpy=normal(period, b, n, 3),
                odom=normal(period, b, n, 4))


def generate(world, config: dict, p: dict, seed: int, device) -> Traffic:
    """A cell's traffic for ``seed``: the host draws (tours, clutter,
    drift) from a NumPy generator, the device draws (MCL) from a
    ``torch.Generator`` on ``device``, both seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    robots, period, dt = config["robots"], p["period_ticks"], config["dt"]
    pos, yaw, v, w, goals, clutter, speeds = tours(world, p, robots, period,
                                                   dt, rng)
    if (p.get("clutter") or {}).get("beside_route"):
        clutter = np.concatenate([clutter, _beside(rng, pos, yaw, world, p)])
    drift = p.get("odometry_drift", {})
    dpos = _periodic_walk(rng, (period, robots, 3), drift.get("pos_sigma", 0))
    dpos[..., 2] = 0.0
    dyaw = _periodic_walk(rng, (period, robots), drift.get("yaw_sigma", 0))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    pos_t, yaw_t = f32(pos), f32(yaw)
    scans, masks = sweeps(pos_t, yaw_t, p.get("bodies"), clutter, world,
                          config["sensor"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    draws, normals = {}, ()
    mcl = config.get("mcl")
    if mcl is not None:
        n = mcl["num_particles"]
        normals = (torch.randn((robots, n, 3), generator=gen, device=device),
                   torch.randn((robots, n, 3), generator=gen, device=device))
        draws = mcl_draws(gen, period, robots, n, device)
    return Traffic(pos=pos_t, quat=_yaw_quat(yaw_t), v=f32(v), w=f32(w),
                   goals=f32(goals), scans=scans, masks=masks,
                   drift_pos=f32(dpos), drift_yaw=f32(dyaw),
                   now=f32(np.arange(CLOCK_TICKS) * dt), dt=f32(dt),
                   draws=draws, init_normals=normals, clutter=clutter,
                   speeds=speeds)
