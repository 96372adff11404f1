"""Entry points of the port's local-planner slice.

* :func:`entry` — the counterpart of ``__graft_entry__.entry()``: one
  single-robot control tick (B = 1) and its example arguments.
* :func:`headline_config` / :func:`headline_inputs` — the 64-robot fleet of
  ``bench.py::bench_headline``: 16×16 dynamic window (289 padded samples),
  40 steps, 512 obstacles per robot, near-K 128, the same seeds, plans and
  obstacles.
* :func:`tick` / :func:`run_chain` — fleet ticks chained through
  ``integrate_fleet``, as the headline's 50-tick chain runs them.
* :func:`config3_config` / :func:`config3_inputs` / :func:`run_fused_chain`
  — the fused perception → replan → local tick of ``bench.py::bench_config3``
  on the multi-level map (3,116 ground nodes, a 96×96×44 window, a 16×1000
  lidar, 64×128 samples of 40 steps), and a chain of such ticks.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dddmr_navigation_tpu_torch.config import (
    DDSimpleGeneratorConfig, GlobalPlannerConfig, LocalPlannerConfig,
    NavigationConfig, PerceptionConfig, SpinningLidarConfig)
from dddmr_navigation_tpu_torch.io.maps import multi_level_map
from dddmr_navigation_tpu_torch.control.fused import (
    build_fused_map, init_fused_state, make_fused_tick)
from dddmr_navigation_tpu_torch.geometry import quat_from_yaw
from dddmr_navigation_tpu_torch.perception.static_weights import (
    compute_node_weights)
from dddmr_navigation_tpu_torch.utils.lidar_sim import BoxWorld, simulate_scan
from dddmr_navigation_tpu_torch.parallel.fleet import (
    FleetState, fleet_tick, integrate_fleet)
from dddmr_navigation_tpu_torch.planning.local.planner import (
    compute_velocity_command, make_global_plan)


def build_inputs(device):
    """``__graft_entry__._build_inputs()`` as tensors with B = 1."""
    n_obs = 512
    cfg = NavigationConfig().local_planner
    xs = np.arange(0, 6.0, 0.1, dtype=np.float32)
    plan_pts = np.stack([xs, 0.3 * np.sin(xs), np.zeros_like(xs)], 1)
    plan = make_global_plan(plan_pts[None], max_len=cfg.max_plan_len,
                            device=device)

    rng = np.random.default_rng(0)
    # scattered obstacles ahead, clear of the robot's immediate footprint
    obstacles = rng.uniform([1.5, -2, 0], [6, 2, 0.5], size=(n_obs, 3)
                            ).astype(np.float32)
    obs = np.zeros((1, cfg.max_obstacle_points, 3), np.float32)
    obs[0, :n_obs] = obstacles
    mask = np.zeros((1, cfg.max_obstacle_points), bool)
    mask[0, :n_obs] = True

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    args = (plan, f32([[0.0, 0.0, 0.0]]), quat_from_yaw(f32([0.1])),
            f32([0.4]), f32([0.0]), torch.as_tensor(obs, device=device),
            torch.as_tensor(mask, device=device), f32([-1.0]), f32([0.0]))
    return cfg, args


def entry(device="cuda"):
    """Returns (fn, example_args): one single-robot control tick."""
    cfg, args = build_inputs(device)

    def fn(plan, pos, quat, v, w, obs, mask, cap, hd):
        cmd = compute_velocity_command(cfg, plan, pos, quat, v, w, obs, mask,
                                       cap, hd)
        return cmd.vx, cmd.wz, cmd.state, cmd.best_cost

    return fn, args


def headline_config(linear_samples: int = 16, angular_samples: int = 16,
                    max_num_steps: int = 40, obstacles_n: int = 512,
                    near_k: int = 128, prune_len: int = 128,
                    plan_len: int = 512) -> LocalPlannerConfig:
    """``bench_headline``'s planner configuration (the defaults); smaller
    values give the same configuration cut to a test's size."""
    return LocalPlannerConfig(
        generator=DDSimpleGeneratorConfig(
            linear_x_sample=linear_samples, angular_z_sample=angular_samples,
            max_num_steps=max_num_steps),
        max_obstacle_points=obstacles_n, collision_obstacle_chunk=16,
        collision_near_k=near_k, max_prune_len=prune_len,
        max_plan_len=plan_len)


def headline_numpy(robots: int, obstacles_n: int):
    """The headline's plans (B, 80, 3), obstacles (B, M, 3), obstacle mask
    and start poses as numpy arrays, from ``bench_headline``'s seeds."""
    b = robots
    xs = np.arange(0, 8.0, 0.1, dtype=np.float32)
    plans = np.stack([np.stack([xs, 0.4 * np.sin(xs + i * 0.3) + 0.02 * i,
                                np.zeros_like(xs)], 1) for i in range(b)])
    rng = np.random.default_rng(0)
    obstacles = rng.uniform([1.0, -2, 0], [8, 2, 0.5],
                            size=(b, obstacles_n, 3)).astype(np.float32)
    obs_valid = np.ones((b, obstacles_n), bool)
    pos = np.stack([np.zeros(b), 0.02 * np.arange(b), np.zeros(b)],
                   1).astype(np.float32)
    return plans, obstacles, obs_valid, pos


def headline_inputs(cfg: LocalPlannerConfig, robots: int = 64, device="cuda"):
    """(plans, start FleetState, obstacles, obs_valid) of the headline."""
    plans_np, obstacles, obs_valid, pos = headline_numpy(
        robots, cfg.max_obstacle_points)
    plans = make_global_plan(plans_np, max_len=cfg.max_plan_len,
                             device=device)
    zeros = torch.zeros((robots,), dtype=torch.float32, device=device)
    state = FleetState(
        pos=torch.as_tensor(pos, device=device),
        quat=quat_from_yaw(zeros),
        v=zeros, w=zeros)
    return (plans, state, torch.as_tensor(obstacles, device=device),
            torch.as_tensor(obs_valid, device=device))


def tick(cfg, plans, state, obstacles, obs_valid):
    """One fleet tick and the perfect-execution step that follows it, as
    in the headline chain. Returns (next state, VelocityCommand)."""
    cmd = fleet_tick(cfg, plans, state, obstacles, obs_valid)
    return integrate_fleet(state, cmd.vx, cmd.wz,
                           1.0 / cfg.controller_frequency), cmd


class Chain(NamedTuple):
    """Per-tick outputs of :func:`run_chain`, stacked on axis 0 (T)."""
    found: torch.Tensor       # (T,) robots with an accepted trajectory
    state: torch.Tensor       # (T, B) PlannerState codes
    best_index: torch.Tensor  # (T, B)
    vx: torch.Tensor          # (T, B)
    wz: torch.Tensor          # (T, B)
    final: FleetState


def run_chain(cfg, plans, state, obstacles, obs_valid, ticks: int) -> Chain:
    """``ticks`` chained fleet ticks from ``state``."""
    found, codes, best, vx, wz = [], [], [], [], []
    for _ in range(ticks):
        state, cmd = tick(cfg, plans, state, obstacles, obs_valid)
        found.append((cmd.best_cost >= 0).sum())
        codes.append(cmd.state)
        best.append(cmd.best_index)
        vx.append(cmd.vx)
        wz.append(cmd.wz)
    return Chain(torch.stack(found), torch.stack(codes), torch.stack(best),
                 torch.stack(vx), torch.stack(wz), state)


# ---------------------------------------------------------------------------
# config 3: the fused vertical on the multi-level map (bench.py:441-491)
# ---------------------------------------------------------------------------

CONFIG3_ROBOT = (8.5, 7.0, 0.0)
CONFIG3_GOAL = (8.5, 7.0, 2.5)          # on the upper floor, via the ramp
CONFIG3_OFFSET = (0.0, 0.0, 0.5)        # lidar above the base
CONFIG3_BOX = ((7.0, 5.8, 0.0), (7.5, 6.6, 1.2))
CONFIG3_V0 = 0.3                        # the bench's v_now


def config3_config(linear_samples: int = 63, angular_samples: int = 127,
                   max_num_steps: int = 40, window_xy: int = 96,
                   window_z: int = 44, rings: int = 16, cols: int = 1000,
                   obstacles_n: int = 2048, near_k: int = 128,
                   max_relax_iters: int = 320) -> NavigationConfig:
    """``bench_config3``'s configuration (the defaults: 64×128 = 8,192
    samples, a 96×96×44 window, 16,000 scan points, 2,048 observation
    points, near-K 128, ``max_long_edges=0`` and the default
    ``turning_weight`` 0.1 over 16 direction bins); smaller values give the
    same configuration cut to a test's size."""
    lidar = SpinningLidarConfig(
        scan_effective_positive_start=0.0, scan_effective_negative_start=0.0,
        max_scan_points=rings * cols, range_image_rows=rings,
        range_image_cols=cols)
    return NavigationConfig(
        perception=PerceptionConfig(lidar=lidar,
                                    voxel_window_cells_xy=window_xy,
                                    voxel_window_cells_z=window_z),
        local_planner=LocalPlannerConfig(
            generator=DDSimpleGeneratorConfig(
                linear_x_sample=linear_samples,
                angular_z_sample=angular_samples,
                max_num_steps=max_num_steps),
            max_obstacle_points=obstacles_n,
            collision_obstacle_chunk=16, collision_near_k=near_k),
        global_planner=GlobalPlannerConfig(max_relax_iters=max_relax_iters,
                                           max_long_edges=0))


def config3_map(resolution: float = 0.25):
    """The multi-level map's (ground, map_pts, node weights, static
    dGraph) as numpy, from the port's numpy map functions."""
    ground, map_pts = multi_level_map(resolution=resolution)
    weights, static_dgraph = compute_node_weights(ground, map_pts)
    return ground, map_pts, weights, static_dgraph


def config3_world(extra_boxes=()):
    """The bench's box world (one box beside the robot), plus any extra
    ``(min_xyz, max_xyz)`` boxes."""
    world = BoxWorld()
    for mn, mx in (CONFIG3_BOX, *extra_boxes):
        world.add_box(mn, mx)
    return world


def config3_scan(cfg: NavigationConfig, world, robot_pos, yaw: float):
    """One sweep at a robot pose, in the sensor frame, as ``bench_config3``
    makes it: (points (N, 3), mask (N,)) with ground returns below 0.15 m
    masked."""
    lidar = cfg.perception.lidar
    robot_pos = np.asarray(robot_pos, np.float32)
    offset = np.asarray(CONFIG3_OFFSET, np.float32)
    pts, mask = simulate_scan(
        world, robot_pos + offset, sensor_yaw=yaw,
        n_rings=lidar.range_image_rows, n_cols=lidar.range_image_cols)
    mask = mask & (pts[:, 2] + robot_pos[2] + offset[2] >= 0.15)
    return pts, mask


class Config3(NamedTuple):
    cfg: NavigationConfig
    fmap: object              # control.fused.FusedMap
    tick: object              # make_fused_tick's callable
    robot: np.ndarray         # (3,) start position
    goal: np.ndarray          # (3,)
    offset: np.ndarray        # (3,) sensor offset


def config3_inputs(cfg: NavigationConfig, device="cuda",
                   resolution: float = 0.25, map_data=None) -> Config3:
    """The fused map and tick of ``bench_config3``. ``map_data`` takes a
    precomputed :func:`config3_map`."""
    ground, map_pts, weights, static_dgraph = (
        map_data if map_data is not None else config3_map(resolution))
    fmap = build_fused_map(cfg, ground, map_pts, node_weight=weights,
                           static_dgraph=static_dgraph, device=device)
    tick = make_fused_tick(cfg)[0]
    return Config3(cfg, fmap, tick, np.asarray(CONFIG3_ROBOT, np.float32),
                   np.asarray(CONFIG3_GOAL, np.float32),
                   np.asarray(CONFIG3_OFFSET, np.float32))


def config3_state(c3: Config3, robots: int = 1):
    """The start state of ``robots`` robots at the config's start."""
    robot = torch.as_tensor(np.tile(c3.robot, (robots, 1)),
                            device=c3.fmap.ground.device)
    return init_fused_state(c3.cfg, c3.fmap.ground.shape[0], robot)


class FusedChain(NamedTuple):
    """Per-tick outputs of :func:`run_fused_chain`, stacked on axis 0 (T)."""
    state: torch.Tensor        # (T, B) PlannerState codes
    best_index: torch.Tensor   # (T, B)
    vx: torch.Tensor           # (T, B)
    wz: torch.Tensor           # (T, B)
    plan_ok: torch.Tensor      # (T, B)
    plan_count: torch.Tensor   # (T, B)
    plan_positions: torch.Tensor  # (T, B, max_plan_len, 3)
    wf_iters: torch.Tensor     # (T, B)
    composed_first: torch.Tensor  # (B, G) composed dGraph of the first tick
    composed_last: torch.Tensor   # (B, G) and of the last
    final: object              # control.fused.FusedState


def run_fused_chain(c3: Config3, state, scans, scan_masks, positions, quats,
                    v, w, tick=None) -> FusedChain:
    """Fused ticks along given poses: tick t takes scans[t] (B, N, 3) in
    the sensor frame, scan_masks[t], positions[t] (B, 3), quats[t]
    (B, 4), v[t] and w[t] (B,), and the state the tick before left.
    ``tick`` replaces ``c3.tick`` (for instance to time each tick)."""
    tick = tick or c3.tick
    dev = c3.fmap.ground.device
    b = positions.shape[1]
    offset = torch.as_tensor(c3.offset, device=dev)
    goal = torch.as_tensor(np.tile(c3.goal, (b, 1)), device=dev)
    outs = []
    for t in range(len(scans)):
        state, out = tick(c3.fmap, state, scans[t], scan_masks[t],
                          positions[t], quats[t], offset, goal, v[t], w[t])
        outs.append(out)

    def stack(field):
        return torch.stack([getattr(o, field) for o in outs])

    return FusedChain(
        state=stack("state"), best_index=stack("best_index"),
        vx=stack("vx"), wz=stack("wz"),
        plan_ok=stack("plan_ok"),
        plan_count=torch.stack([o.plan.count for o in outs]),
        plan_positions=torch.stack([o.plan.positions for o in outs]),
        wf_iters=stack("wf_iters"),
        composed_first=outs[0].composed_dgraph,
        composed_last=outs[-1].composed_dgraph, final=state)
