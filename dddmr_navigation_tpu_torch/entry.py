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
* :func:`config4_config` / :func:`config4_world` / :func:`config4_inputs` /
  :func:`config4_state` / :func:`run_fleet_full_chain` — the full-fidelity
  fleet of ``bench.py::bench_config4``: 64 robots localizing with MCL on
  drifting odometry, mark/clear, one turning-wavefront relaxation for the
  fleet, the simple and rotate generators, the move-base FSM and the
  rotate recovery, on a 12×8 m warehouse floor (1,617 ground nodes).
* :func:`session_config` / :func:`session_scenario` / :func:`make_session`
  / :func:`session_inputs` / :func:`run_session_chain` — one robot's
  ``control.session.NavigationSession`` (perception, depth cameras, zone
  layers, DWA replans, the local planner, the move-base FSM) closed loop
  through the repo's session demo (``examples/run_navigation_session.py``):
  a 14×8 m floor at 0.2 m, a 2.8 m wall across the route, a no-entry zone
  and a slow zone.
* :func:`global_localization_scenario` / :func:`make_global_localization`
  / :func:`run_global_localization` — global localization from an unknown
  start in the JAX package's box world (``tests/test_state_estimation.py``:
  a 12×12 m ground grid and two 12 m walls): 2,048 particles over the
  ground × 16 yaws, shrunk ×0.75 every second tick down to the runtime
  filter's 32, while the robot circles 0.5 m around (-2.5, 2.5).
* :func:`run_sharded_fleet_full_chain` — the config-4 fleet through
  ``parallel.fleet.sharded_fleet_full_tick``, this rank's robots only.
* :func:`slam_scenario` / :func:`make_mapping_session` /
  :func:`run_mapping_chain` / :func:`replay_mapping` — one mapping run
  (``slam.pipeline.MappingSession``) at ``SlamConfig()``'s full width
  through ``bench.py::bench_slam``'s world: a closed 3 m circle of 56
  scans that closes loops on its second pass, and the teacher-forced
  replay of the JAX package's recorded run.
* :func:`semantic_scenario` / :func:`load_segmenter` /
  :func:`run_semantic_reroute` — the DDRNet-slim segmenter at full width
  (the committed 19-class artifact at 240×320 on EVAL-family frames, as
  ``bench.py::bench_semantic`` runs it) and the 4-class artifact's
  mask → class cloud → no-entry field → global-plan reroute of
  ``tests/test_semantic_e2e.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import dataclasses
import functools
import json
import os
import time

import numpy as np
import torch

from dddmr_navigation_tpu_torch.config import (
    DDSimpleGeneratorConfig, GlobalPlannerConfig, LocalPlannerConfig,
    MCLConfig, MoveBaseConfig, NavigationConfig, PerceptionConfig,
    SlamConfig, SpinningLidarConfig)
from dddmr_navigation_tpu_torch.io.maps import (
    box_obstacle, flat_ground_map, multi_level_map)
from dddmr_navigation_tpu_torch.control.fused import (
    build_fused_map, init_fused_state, make_fused_tick)
from dddmr_navigation_tpu_torch.geometry import quat_from_yaw
from dddmr_navigation_tpu_torch.interop import (
    port_session_state, tick_of, to_numpy)
from dddmr_navigation_tpu_torch.perception.depth_camera import (
    CameraModel, frustum_planes, in_frustum)
from dddmr_navigation_tpu_torch.perception.static_weights import (
    compute_node_weights)
from dddmr_navigation_tpu_torch.utils.lidar_sim import BoxWorld, simulate_scan
from dddmr_navigation_tpu_torch.parallel.fleet import (
    FleetState, feature_keys, fleet_full_tick, fleet_tick,
    init_fleet_full_state, integrate_fleet)
from dddmr_navigation_tpu_torch.state_estimation.likelihood import (
    build_submap_context)
from dddmr_navigation_tpu_torch.planning.local.planner import (
    compute_velocity_command, make_global_plan)
from dddmr_navigation_tpu_torch.perception import semantic_scene19 as s19
from dddmr_navigation_tpu_torch.perception.layers import no_entry_dgraph
from dddmr_navigation_tpu_torch.planning.global_.graph import (
    build_ground_graph)
from dddmr_navigation_tpu_torch.planning.global_.planner import plan_on_graph
from dddmr_navigation_tpu_torch.perception.semantic import (
    DDRNetSlim, infer_classes, init_segmenter, load_params,
    segmentation_to_pointcloud)
from dddmr_navigation_tpu_torch.perception.semantic_data import (
    CameraIntrinsics, camera_to_world, render_scene)
from dddmr_navigation_tpu_torch.runtime import tracing


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
                    v, w) -> FusedChain:
    """Fused ticks along given poses: tick t takes scans[t] (B, N, 3) in
    the sensor frame, scan_masks[t], positions[t] (B, 3), quats[t]
    (B, 4), v[t] and w[t] (B,), and the state the tick before left."""
    dev = c3.fmap.ground.device
    b = positions.shape[1]
    offset = torch.as_tensor(c3.offset, device=dev)
    goal = torch.as_tensor(np.tile(c3.goal, (b, 1)), device=dev)
    outs = []
    for t in range(len(scans)):
        state, out = c3.tick(c3.fmap, state, scans[t], scan_masks[t],
                             positions[t], quats[t], offset, goal, v[t],
                             w[t])
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


# ---------------------------------------------------------------------------
# config 4: the full-fidelity fleet (bench.py:721-908)
# ---------------------------------------------------------------------------

CONFIG4_ROBOTS = 64
CONFIG4_TICKS = 10                      # warm ticks after the cold one
CONFIG4_DT = 0.1
CONFIG4_OFFSET = (0.0, 0.0, 0.3)        # lidar above the base
CONFIG4_DRIFT_DIR = (0.7, 0.7, 0.0)     # odometry drift, 0.01 m per tick


def config4_config(linear_samples: int = 16, angular_samples: int = 16,
                   max_num_steps: int = 40, obstacles_n: int = 512,
                   near_k: int = 128, scan_points: int = 2048,
                   window_xy: int = 64, window_z: int = 24,
                   marked_voxels: int = 512, window_nodes: int = 2048,
                   max_relax_iters: int = 192, particles: int = 60):
    """``bench_config4``'s (NavigationConfig, MoveBaseConfig, MCLConfig)
    (the defaults: 16×16 samples of 40 steps, 512 obstacles, near-K 128,
    2,048 scan points, a 64×64×24 window with 512 marked voxels and 2,048
    window nodes, cluster pool 2; turning weight 0.1 with 256 long edges, 8
    LOS samples, 512 lethal points and 192 relaxation iterations; 60
    particles in ``corr`` mode); smaller values cut it to a test's size."""
    lidar = SpinningLidarConfig(
        scan_effective_positive_start=0.0, scan_effective_negative_start=0.0,
        max_scan_points=scan_points)
    cfg = NavigationConfig(
        perception=PerceptionConfig(
            lidar=lidar, voxel_window_cells_xy=window_xy,
            voxel_window_cells_z=window_z, max_marked_voxels=marked_voxels,
            max_window_nodes=window_nodes, cluster_pool=2),
        local_planner=LocalPlannerConfig(
            generator=DDSimpleGeneratorConfig(
                linear_x_sample=linear_samples,
                angular_z_sample=angular_samples,
                max_num_steps=max_num_steps),
            max_obstacle_points=obstacles_n, collision_obstacle_chunk=16,
            collision_near_k=near_k),
        global_planner=GlobalPlannerConfig(
            turning_weight=0.1, max_long_edges=256, los_samples=8,
            max_lethal_points=512, max_relax_iters=max_relax_iters,
            relax_iters_per_tick=0))
    mcl = MCLConfig(num_particles=particles, init_var_x=0.3, init_var_y=0.3,
                    init_var_z=0.1, init_var_yaw=0.1, field_sampling="corr")
    return cfg, MoveBaseConfig(), mcl


class Config4World(NamedTuple):
    """The bench's world and start, as numpy."""
    ground: np.ndarray        # (G, 3) ground nodes
    walls: np.ndarray         # (W, 3) warehouse walls (map and MCL features)
    positions: np.ndarray     # (B, 3) start poses
    quats: np.ndarray         # (B, 4)
    goals: np.ndarray         # (B, 3)
    scans: np.ndarray         # (B, N, 3) each robot's sweep, sensor frame
    masks: np.ndarray         # (B, N)


def config4_world(robots: int = CONFIG4_ROBOTS,
                  scan_points: int = 2048) -> Config4World:
    """The bench's warehouse: a 12×8 m floor at 0.25 m, its four walls,
    robots in a column at x = -4 heading for x = 4, each sweeping one
    0.2 m box ahead-left of its start (the sweep is the same every tick)."""
    ground = flat_ground_map(12, 8, 0.25)
    walls = np.concatenate([
        box_obstacle([-5.6, 0.0, 0.0], size=(0.3, 7.4, 1.2), resolution=0.15),
        box_obstacle([5.6, 0.0, 0.0], size=(0.3, 7.4, 1.2), resolution=0.15),
        box_obstacle([0.0, -3.6, 0.0], size=(11.0, 0.3, 1.2),
                     resolution=0.15),
        box_obstacle([0.0, 3.6, 0.0], size=(11.0, 0.3, 1.2),
                     resolution=0.15),
    ]).astype(np.float32)
    b = robots
    lane = 0.1 * (np.arange(b) - b / 2)
    positions = np.stack([np.full(b, -4.0), lane, np.zeros(b)],
                         1).astype(np.float32)
    goals = np.stack([np.full(b, 4.0), lane, np.zeros(b)],
                     1).astype(np.float32)
    quats = np.tile(np.asarray([[0.0, 0.0, 0.0, 1.0]], np.float32), (b, 1))
    scans = np.zeros((b, scan_points, 3), np.float32)
    masks = np.zeros((b, scan_points), bool)
    for i in range(b):
        box = box_obstacle([positions[i, 0] + 0.8, positions[i, 1] + 0.55,
                            0.0], size=(0.2, 0.2, 1.0), resolution=0.1)
        rel = box - (positions[i] + np.asarray(CONFIG4_OFFSET))
        scans[i, :len(rel)] = rel[:scan_points]
        masks[i, :min(len(rel), scan_points)] = True
    return Config4World(ground, walls, positions, quats, goals, scans, masks)


def config4_drift(t: int, robots: int = CONFIG4_ROBOTS):
    """Tick ``t``'s odometry drift (B, 3), drift yaw (B,) and clock, in f32
    as the bench computes them: 0.01·t m along (0.7, 0.7, 0), t·0.1 s."""
    d = (np.float32(0.01) * np.float32(t)) * np.asarray(CONFIG4_DRIFT_DIR,
                                                       np.float32)
    return (np.tile(d, (robots, 1)), np.zeros((robots,), np.float32),
            np.float32(t) * np.float32(CONFIG4_DT))


class Config4(NamedTuple):
    cfg: NavigationConfig
    mb: MoveBaseConfig
    mcl: MCLConfig
    world: Config4World
    fmap: object              # control.fused.FusedMap
    submap: object            # state_estimation.likelihood.SubmapContext
    specs: tuple              # (VoxelSpec, RangeImageSpec, MarkingParams)
    walls: torch.Tensor       # (W, 3) feature map points
    ground: torch.Tensor      # (G, 3) feature ground points
    keys: tuple               # their feature-order keys
    scans: torch.Tensor       # (B, N, 3)
    masks: torch.Tensor       # (B, N)
    goals: torch.Tensor       # (B, 3)
    offset: torch.Tensor      # (3,)


def config4_inputs(configs=None, world=None, device="cuda") -> Config4:
    """The shared map, submap and tensors of ``bench_config4`` (or of the
    given ``configs`` = (cfg, mb, mcl) and ``world``) on ``device``."""
    cfg, mb, mcl = configs if configs is not None else config4_config()
    w = world if world is not None else config4_world(
        scan_points=cfg.perception.lidar.max_scan_points)

    def t(x):
        return torch.as_tensor(np.asarray(x), device=device)
    walls, ground = t(w.walls), t(w.ground)
    return Config4(
        cfg=cfg, mb=mb, mcl=mcl, world=w,
        fmap=build_fused_map(cfg, w.ground, w.walls, device=device),
        submap=build_submap_context(w.walls, w.ground, mcl, device=device),
        specs=make_fused_tick(cfg)[1:], walls=walls, ground=ground,
        keys=(feature_keys(len(w.walls), device),
              feature_keys(len(w.ground), device)),
        scans=t(w.scans), masks=t(w.masks), goals=t(w.goals),
        offset=t(np.asarray(CONFIG4_OFFSET, np.float32)))


def config4_state(c4: Config4, mcl_normals):
    """The start state: every robot at rest at its start, its filter's
    particles spread by ``mcl_normals`` (two (B, N, 3) unit-normal
    tensors, see ``state_estimation.mcl.init_draws``)."""
    return init_fleet_full_state(
        c4.cfg, len(c4.world.ground), c4.world.positions, c4.world.quats,
        mcl_cfg=c4.mcl, mcl_normals=mcl_normals,
        device=c4.fmap.ground.device)


def config4_tick_inputs(c4: Config4, t: int, robots: int) -> dict:
    """Tick ``t``'s clock, time step and odometry drift as tensors on the
    config's device: the keyword arguments :func:`config4_tick` adds."""
    dev = c4.fmap.ground.device
    drift, drift_yaw, now = config4_drift(t, robots)
    return dict(now=torch.tensor(now, device=dev),
                dt=torch.tensor(np.float32(CONFIG4_DT), device=dev),
                odom_drift_pos=torch.as_tensor(drift, device=dev),
                odom_drift_yaw=torch.as_tensor(drift_yaw, device=dev))


def config4_tick(c4: Config4, state, t: int, draws, inputs=None):
    """Tick ``t`` of the chain from ``state`` with this tick's MCL draws
    (``state_estimation.pf.MCLDraws``) and :func:`config4_tick_inputs`
    (made here unless given). Returns (state, diag)."""
    if inputs is None:
        inputs = config4_tick_inputs(c4, t, state.pos.shape[0])
    spec, ri, params = c4.specs
    return fleet_full_tick(
        c4.cfg, c4.mb, spec, ri, params, c4.fmap, state, c4.scans, c4.masks,
        c4.offset, c4.goals, mcl_cfg=c4.mcl, submap_ctx=c4.submap,
        feature_map_pts=c4.walls, feature_ground_pts=c4.ground,
        mcl_draws=draws, feature_keys_=c4.keys, **inputs)


FLEET_DIAG = ("decision", "cmd_source", "ps_simple", "ps_rotate", "plan_ok",
              "wf_iters", "vx", "wz", "plan_pos", "plan_yaw", "mcl_err",
              "best_index", "recovery_active")


def run_fleet_full_chain(c4: Config4, state, draws_of, ticks: int,
                         t0: int = 0, forced=None, inputs_of=None):
    """``ticks`` chained full ticks from tick ``t0``: tick t draws from
    ``draws_of(t)``. ``forced(t)``, when given, returns a dict of
    FleetFullState fields (the true pose and twist, the MCL state) to put
    in place before tick t, or None: the teacher forcing of a chain held
    against a recorded one. ``inputs_of(t)`` gives tick t's
    :func:`config4_tick_inputs` (made per tick when not given). Returns
    ({name: (T, B, ...) tensor} for :data:`FLEET_DIAG`, final state)."""
    outs = {k: [] for k in FLEET_DIAG}
    for t in range(t0, t0 + ticks):
        f = forced(t) if forced is not None else None
        if f:
            state = state._replace(**f)
        state, diag = config4_tick(c4, state, t, draws_of(t),
                                   inputs_of(t) if inputs_of else None)
        for k in FLEET_DIAG:
            outs[k].append(diag[k])
    return {k: torch.stack(v) for k, v in outs.items()}, state


# ---------------------------------------------------------------------------
# the single-robot session (examples/run_navigation_session.py)
# ---------------------------------------------------------------------------

SESSION_START = (-3.0, 0.0, 0.0)
SESSION_GOAL = (3.5, 0.0, 0.0)
SESSION_WALL = ((-0.1, -1.4, 0.0), (0.1, 1.4, 1.2))   # across the route
SESSION_OFFSET = (0.0, 0.0, 0.5)                      # lidar above the base
SESSION_DT = 0.1
SESSION_TICKS = 600
# two depth cameras 0.4 m above the base, looking 0.4 rad left and right
SESSION_CAM_OFFSET = (0.1, 0.0, 0.4)
SESSION_CAM_YAWS = (0.4, -0.4)


def session_config(range_rows: int = 32, range_cols: int = 360,
                   window_xy: int = 72, window_z: int = 24,
                   linear_x_sample: int = 5, angular_z_sample: int = 10,
                   max_num_steps: int = 64) -> NavigationConfig:
    """The session demo's configuration: ``NavigationConfig()`` (the
    reference YAML's values) with a 32×360 range image over ±40°, every
    azimuth effective, and a 72×72×24 window; smaller values give the same
    configuration cut to a test's size."""
    lidar = SpinningLidarConfig(
        xy_resolution=0.1, height_resolution=0.1,
        range_image_rows=range_rows, range_image_cols=range_cols,
        vertical_FOV_bottom=-40.0, vertical_FOV_top=40.0,
        scan_effective_positive_start=0.0, scan_effective_positive_end=180.0,
        scan_effective_negative_start=0.0,
        scan_effective_negative_end=-180.0)
    cfg = NavigationConfig()
    lp = cfg.local_planner
    return dataclasses.replace(
        cfg,
        perception=PerceptionConfig(lidar=lidar,
                                    voxel_window_cells_xy=window_xy,
                                    voxel_window_cells_z=window_z),
        local_planner=dataclasses.replace(lp, generator=dataclasses.replace(
            lp.generator, linear_x_sample=linear_x_sample,
            angular_z_sample=angular_z_sample, max_num_steps=max_num_steps)))


def _grid_points(x0, x1, y0, y1, step=0.1):
    xs = np.arange(x0, x1 + 1e-6, step)
    ys = np.arange(y0, y1 + 1e-6, step)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    return np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)],
                    1).astype(np.float32)


class SessionScenario(NamedTuple):
    cfg: NavigationConfig
    ground: np.ndarray          # (G, 3)
    world: object               # utils.lidar_sim.BoxWorld
    start: np.ndarray           # (3,)
    goal: np.ndarray            # (3,)
    no_entry: np.ndarray        # (Z, 3) zone points
    speed_zone: tuple           # ((Z, 3) points, (Z,) speeds)
    camera: CameraModel
    cameras: int
    depth_points: int           # points kept per camera frame
    buffer_depth: int
    scan_rings: int
    scan_cols: int


def session_scenario(cfg: NavigationConfig = None, size=(14.0, 8.0),
                     room_half: float = 6.0, start=SESSION_START,
                     goal=SESSION_GOAL, wall=SESSION_WALL,
                     no_entry=(-0.5, 0.5, 1.5, 4.0), slow_from: float = 1.5,
                     depth_points: int = 1024, scan_rings: int = 24,
                     scan_cols: int = 240) -> SessionScenario:
    """The session demo's world (``BoxWorld.room(6.0, 1.5)`` with the wall
    across the route), its route from (-3, 0) to (3.5, 0) over
    ``flat_ground_map(14, 8, 0.2)`` (2,911 nodes), and what the demo leaves
    out: two depth cameras (``CameraModel()``, 3-deep rings, 1,024 points,
    fed from the same world), a no-entry zone at x ∈ [-0.5, 0.5],
    y ∈ [1.5, 4.0] (the detour goes to the -y side) and a 0.2 m/s zone over
    the last ``slow_from`` m before the goal. Smaller arguments cut it to a
    test's size."""
    cfg = cfg if cfg is not None else session_config()
    world = BoxWorld.room(half=room_half, wall_h=1.5)
    world.add_box(*wall)
    goal = np.asarray(goal, np.float32)
    zone = _grid_points(*no_entry)
    slow = _grid_points(goal[0] - slow_from, goal[0], goal[1] - 0.5,
                        goal[1] + 0.5, 0.25)
    return SessionScenario(
        cfg=cfg, ground=flat_ground_map(size[0], size[1], 0.2), world=world,
        start=np.asarray(start, np.float32), goal=goal, no_entry=zone,
        speed_zone=(slow, np.full((len(slow),), 0.2, np.float32)),
        camera=CameraModel(), cameras=len(SESSION_CAM_YAWS),
        depth_points=depth_points, buffer_depth=3, scan_rings=scan_rings,
        scan_cols=scan_cols)


def make_session(sc: SessionScenario, device="cuda",
                 threaded_plan_manager: bool = False):
    """The scenario's ``NavigationSession`` with its cameras and zones."""
    from dddmr_navigation_tpu_torch.control.session import NavigationSession
    return NavigationSession(
        sc.cfg, sc.ground, no_entry_zones=sc.no_entry,
        speed_zones=sc.speed_zone, sensor_offset=SESSION_OFFSET,
        threaded_plan_manager=threaded_plan_manager,
        depth_cameras=sc.cameras, depth_camera_model=sc.camera,
        depth_buffer_depth=sc.buffer_depth, depth_max_points=sc.depth_points,
        device=device)


def session_scan(sc: SessionScenario, pos, yaw: float):
    """The demo's sweep at a pose, in the sensor frame: 24×240 rays over
    ±40° out to 15 m, returns below 0.15 m (the ground) masked."""
    pos = np.asarray(pos, np.float32)
    pts, mask = simulate_scan(
        sc.world, pos + np.asarray(SESSION_OFFSET, np.float32),
        sensor_yaw=yaw, n_rings=sc.scan_rings, n_cols=sc.scan_cols,
        v_bottom=-40.0, v_top=40.0, max_range=15.0)
    mask = mask & (pts[:, 2] + pos[2] + SESSION_OFFSET[2] >= 0.15)
    return pts, mask


def session_depth_frames(sc: SessionScenario, pos, yaw: float):
    """Each camera's frame at a robot pose: rays cast from the camera into
    the same world (``lidar_sim``), the returns inside its frustum and
    above the floor (0.15 m), every k-th kept to at most
    ``depth_points``. Returns a list of (cam_pos (3,), cam_quat (4,),
    world points (n, 3))."""
    cam = sc.camera
    pos = np.asarray(pos, np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    off = np.asarray(SESSION_CAM_OFFSET, np.float32)
    cam_pos = (pos + np.array([c * off[0] - s * off[1],
                               s * off[0] + c * off[1], off[2]])
               ).astype(np.float32)
    frames = []
    for dyaw in SESSION_CAM_YAWS:
        cyaw = np.float32(yaw + dyaw)
        quat = quat_from_yaw(torch.tensor([cyaw]))[0]
        pts, mask = simulate_scan(
            sc.world, cam_pos, sensor_yaw=float(cyaw), n_rings=24,
            n_cols=360, v_bottom=-23.0, v_top=23.0,
            max_range=cam.max_detect_distance)
        ca, sa = np.cos(cyaw), np.sin(cyaw)
        rot = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]], np.float32)
        world_pts = (pts[mask] @ rot.T + cam_pos).astype(np.float32)
        # the floor's returns dropped, as the scan's are
        world_pts = world_pts[world_pts[:, 2] >= 0.15]
        normals, planes = frustum_planes(cam, torch.from_numpy(cam_pos),
                                         quat)
        inside = in_frustum(normals, planes,
                            torch.from_numpy(world_pts)).numpy()
        world_pts = world_pts[inside]
        if len(world_pts) > sc.depth_points:
            world_pts = world_pts[::-(-len(world_pts) // sc.depth_points)]
        frames.append((cam_pos, quat.numpy(), world_pts))
    return frames


def step_pose(pos, yaw: float, v: float, w: float, dt: float = SESSION_DT):
    """The demo's perfect-execution step: (pos (3,) f32, yaw float)."""
    pos = pos + np.array([v * np.cos(yaw) * dt, v * np.sin(yaw) * dt, 0.0],
                         np.float32)
    return pos, float(yaw + w * dt)


def session_inputs(sc: SessionScenario, pos, yaw: float):
    """One tick's sensor inputs at a pose: (scan points, scan mask, robot
    quat (4,), depth frames)."""
    pts, mask = session_scan(sc, pos, yaw)
    quat = quat_from_yaw(torch.tensor([np.float32(yaw)]))[0].numpy()
    return pts, mask, quat, session_depth_frames(sc, pos, yaw)


class SessionChain(NamedTuple):
    """Per-tick records of :func:`run_session_chain` (numpy, T ticks)."""
    pos: np.ndarray            # (T, 3) pose each tick started from
    yaw: np.ndarray            # (T,)
    vx: np.ndarray             # (T,) commands
    wz: np.ndarray             # (T,)
    decision: np.ndarray       # (T,) int
    done: np.ndarray           # (T,) bool
    succeeded: np.ndarray      # (T,) bool
    plan_count: np.ndarray     # (T,) poses of the adopted plan, 0 for none


def run_session_chain(sess, sc: SessionScenario, ticks: int = SESSION_TICKS,
                      inputs=None, on_tick=None) -> SessionChain:
    """The scenario closed loop on ``sess`` (its goal set here): each tick
    pushes the cameras' frames, ticks the session and steps the pose with
    the command, until ``done`` or ``ticks`` ticks. ``inputs(t, pos, yaw)``
    replaces :func:`session_inputs`; ``on_tick(t, result)`` sees each
    tick's (vx, wz, decision, done, succeeded)."""
    sess.set_goal(sc.goal)
    pos, yaw, v, w = sc.start.copy(), 0.0, 0.0, 0.0
    rec = {k: [] for k in SessionChain._fields}
    for t in range(ticks):
        now = t * SESSION_DT
        pts, mask, quat, frames = (inputs or (
            lambda _t, p, y: session_inputs(sc, p, y)))(t, pos, yaw)
        for c, (cp, cq, dp) in enumerate(frames):
            sess.push_depth_observation(c, cp, cq, dp, now)
        out = sess.tick(pts, mask, pos, quat, v, w, now)
        if on_tick is not None:
            on_tick(t, out)
        vx, wz, dec, done, ok = out
        plan = sess.driver.plan
        for k, val in (("pos", pos), ("yaw", yaw), ("vx", vx), ("wz", wz),
                       ("decision", int(dec)), ("done", done),
                       ("succeeded", ok),
                       ("plan_count", 0 if plan is None
                        else int(np.asarray(to_numpy(plan.count)).sum()))):
            rec[k].append(val)
        v, w = vx, wz
        pos, yaw = step_pose(pos, yaw, v, w)
        if done:
            break
    return SessionChain(**{k: np.asarray(v) for k, v in rec.items()})


def session_golden_inputs(g, t: int, sc: SessionScenario) -> dict:
    """Tick ``t``'s recorded inputs of a session golden record
    (``tools/make_session_golden.py``): the scan (zeros where no ray
    returned), the pose, twist and clock, each camera's frame, the state
    the tick started from (``interop.session_fields`` names) with the
    depth ring's points (``ring``) put back from the frames that filled
    its slots, and the composed field after the tick (sparse)."""
    r = tick_of(g, t, "tick_")
    n = int(r["scan_n"])
    pts = np.zeros((n, 3), np.float32)
    pts[r["scan_idx"]] = r["scan_pts"]
    mask = np.zeros((n,), bool)
    mask[r["scan_idx"]] = True
    frames = [(r[f"cam_pos{c}"], r[f"cam_quat{c}"], r[f"depth_pts{c}"])
              for c in range(sc.cameras)]
    state = {k[len("state_"):]: v for k, v in r.items()
             if k.startswith("state_")}
    stamp = state["depth_buffer_stamp"]
    ring = np.zeros(stamp.shape + (sc.depth_points, 3), np.float32)
    for c, k in zip(*np.nonzero(np.isfinite(stamp))):
        src = int(round(float(stamp[c, k]) / SESSION_DT))
        key = f"depth_pts{c}"
        frame = tick_of(g, src, "tick_", [key])[key][:sc.depth_points]
        ring[c, k, :len(frame)] = frame
    return dict(pts=pts, mask=mask, pos=g["pos"][t], quat=r["quat"],
                v=float(r["v"]), w=float(r["w"]), now=float(r["now"]),
                frames=frames, state=state, ring=ring,
                composed=(r["composed_idx"], r["composed_val"]))


def replay_session(sess, sc: SessionScenario, g, forced: bool = False,
                   ticks: int = None, first: int = 0) -> list:
    """A session golden record's ticks ``first``, ``first + 1``, ... (all
    by default) through ``sess`` (fresh; its goal set here), each from its
    recorded inputs; with ``forced`` each tick first restores the recorded
    state (``interop.port_session_state``). Returns per tick a dict of the
    outputs the record holds."""
    sess.set_goal(sc.goal)
    dwa = sess.driver.plan_manager.dwa
    out = []
    if ticks is None:
        ticks = int(g["replay_ticks"]) - first
    for t in range(first, first + ticks):
        x = session_golden_inputs(g, t, sc)
        if forced:
            sess.restore_state(port_session_state(x["state"], sess.device,
                                                  x["ring"]))
        for c, (cp, cq, dp) in enumerate(x["frames"]):
            sess.push_depth_observation(c, cp, cq, dp, x["now"])
        sess.driver.last_planner_state = -1
        dwa.last_pivot = -1
        vx, wz, dec, done, ok = sess.tick(x["pts"], x["mask"], x["pos"],
                                          x["quat"], x["v"], x["w"], x["now"])
        plan = sess.driver.plan
        out.append(dict(
            vx=vx, wz=wz, decision=int(dec), done=done, succeeded=ok,
            planner_state=int(sess.driver.last_planner_state),
            pivot=int(dwa.last_pivot),
            plan_count=0 if plan is None else int(plan.count[0]),
            composed=sess.composed_dgraph.cpu().numpy(),
            want_composed=x["composed"]))
    return out


REPLAY_INTS = ("decision", "planner_state", "plan_count", "done",
               "succeeded", "pivot")


def replay_errors(g, out, first: int = 0) -> tuple:
    """A replay's differences from its golden record (``out`` from tick
    ``first`` on): (integer mismatches as (tick, name, got, want), max
    |dvx|, max |dwz|, max composed-field difference)."""
    bad, dv, dw, dc = [], 0.0, 0.0, 0.0
    fill = float(g["tick_state_dgraph_fill"][0])
    for t, o in enumerate(out, start=first):
        for k in REPLAY_INTS:
            if int(o[k]) != int(g[k][t]):
                bad.append((t, k, int(o[k]), int(g[k][t])))
        dv = max(dv, abs(o["vx"] - float(g["vx"][t])))
        dw = max(dw, abs(o["wz"] - float(g["wz"][t])))
        idx, val = o["want_composed"]
        want = np.full_like(o["composed"], fill)
        want[idx] = val
        dc = max(dc, float(np.abs(o["composed"] - want).max()))
    return bad, dv, dw, dc


# ---------------------------------------------------------------------------
# global localization (tests/test_state_estimation.py's box world)
# ---------------------------------------------------------------------------

GLOBALLOC_CENTER = (-2.5, 2.5, 0.0)     # the truth circles 0.5 m around it
GLOBALLOC_DT = 0.25


def globalloc_world():
    """Ground plane + two walls (``_synthetic_world`` of the JAX package's
    state-estimation tests): a 49×49 grid over ±6 m and walls at y = 4 and
    x = -4, 61×8 points each. Returns (map_pts, ground_pts)."""
    gx, gy = np.meshgrid(np.linspace(-6, 6, 49), np.linspace(-6, 6, 49))
    ground = np.stack([gx.ravel(), gy.ravel(), np.zeros(gx.size)], 1)
    wx = np.linspace(-6, 6, 61)
    wz = np.linspace(0.2, 1.6, 8)
    WX, WZ = np.meshgrid(wx, wz)
    wall1 = np.stack([WX.ravel(), np.full(WX.size, 4.0), WZ.ravel()], 1)
    wall2 = np.stack([np.full(WX.size, -4.0), WX.ravel(), WZ.ravel()], 1)
    return np.concatenate([wall1, wall2]).astype(np.float32), \
        ground.astype(np.float32)


def globalloc_scan_features(map_pts, ground_pts, pos, yaw, n_flat=96,
                            n_sharp=96, radius=5.0, rng=None):
    """Simulated feature extraction (``_scan_features`` of the same
    tests): up to ``n_flat`` ground and ``n_sharp`` map points within
    ``radius`` of ``pos`` in xy, drawn by ``rng``, in the base frame.
    Returns numpy (flat (n_flat, 3), flat mask, sharp (n_sharp, 3), sharp
    mask)."""
    rng = rng or np.random.default_rng(0)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

    def take(pts, n):
        d = np.linalg.norm(pts[:, :2] - pos[None, :2], axis=1)
        cand = pts[d < radius]
        idx = rng.choice(len(cand), size=min(n, len(cand)), replace=False)
        sel = (cand[idx] - pos[None, :]) @ R  # world→base: R^T on the right
        out = np.zeros((n, 3), np.float32)
        m = np.zeros((n,), bool)
        out[:len(sel)] = sel
        m[:len(sel)] = True
        return out, m

    flat, flat_m = take(ground_pts, n_flat)
    sharp, sharp_m = take(map_pts, n_sharp)
    return flat, flat_m, sharp, sharp_m


def globalloc_pose(t: int):
    """The true pose at tick ``t``: (position (3,) f32, yaw) on the 0.5 m
    circle around :data:`GLOBALLOC_CENTER`, 0.08 rad a tick."""
    th = 0.08 * t
    p = np.asarray(GLOBALLOC_CENTER, np.float32) + np.array(
        [0.5 * np.cos(th), 0.5 * np.sin(th), 0.0], np.float32)
    return p, 0.6 + 0.25 * th


class GlobalLocScenario(NamedTuple):
    cfg: MCLConfig
    map_pts: np.ndarray       # (M, 3)
    ground_pts: np.ndarray    # (G, 3)
    num_start: int
    yaw_samples: int
    shrink_every: int
    res: float                # the submap's field resolution
    ticks: int                # ticks at most
    n_sharp: int              # sharp feature points a scan
    radius: float             # the scan's radius


def global_localization_scenario(num_start: int = 2048,
                                 shrink_every: int = 2,
                                 ticks: int = 80) -> GlobalLocScenario:
    """The JAX package's global-localization test: its MCL settings (32
    runtime particles, init spread 0.3/0.3/0.05 m, 0.02/0.02/0.15 rad,
    expansion resetting live below a 0.6 match ratio), a 0.2 m submap of
    :func:`globalloc_world`, 2,048 seed particles × a 16-way yaw grid
    shrunk every second tick, 192 sharp features within 9 m, up to 80
    ticks. Smaller arguments cut it to a test's size."""
    cfg = MCLConfig(num_particles=32, init_var_x=0.3, init_var_y=0.3,
                    init_var_z=0.05, init_var_roll=0.02, init_var_pitch=0.02,
                    init_var_yaw=0.15, match_ratio_thresh=0.6)
    map_pts, ground_pts = globalloc_world()
    return GlobalLocScenario(cfg, map_pts, ground_pts, num_start, 16,
                             shrink_every, 0.2, ticks, 192, 9.0)


def globalloc_inputs(sc: GlobalLocScenario, t: int) -> dict:
    """Tick ``t``'s (t ≥ 1) inputs as numpy: odometry (the truth, f32)
    before and now as positions and yaws, and the scan's features drawn
    with ``default_rng(t)``."""
    pos_prev, yaw_prev = globalloc_pose(t - 1)
    pos, yaw = globalloc_pose(t)
    flat, flat_m, sharp, sharp_m = globalloc_scan_features(
        sc.map_pts, sc.ground_pts, pos, yaw, n_sharp=sc.n_sharp,
        radius=sc.radius, rng=np.random.default_rng(t))
    return dict(odom_prev_pos=pos_prev, odom_prev_yaw=np.float32(yaw_prev),
                odom_pos=pos, odom_yaw=np.float32(yaw), flat=flat,
                flat_m=flat_m, sharp=sharp, sharp_m=sharp_m)


def make_global_localization(sc: GlobalLocScenario, generator=None,
                             seed_draws=None, ctx=None, device="cuda"):
    """The scenario's ``GlobalLocalization`` on ``device``: its submap
    built here unless ``ctx`` is given, the seed drawn from ``generator``
    unless ``seed_draws`` gives it."""
    from dddmr_navigation_tpu_torch.state_estimation.global_localization \
        import GlobalLocalization
    if ctx is None:
        ctx = build_submap_context(sc.map_pts, sc.ground_pts, sc.cfg,
                                   res=sc.res, device=device)
    return GlobalLocalization(
        sc.cfg, ctx, sc.ground_pts, num_start=sc.num_start,
        yaw_samples=sc.yaw_samples, shrink_every=sc.shrink_every,
        generator=generator, seed_draws=seed_draws, device=device)


class GlobalLocChain(NamedTuple):
    """Per-tick records of :func:`run_global_localization` (T ticks)."""
    n: list                   # particles the tick's update ran at
    fix_cnt: list             # the countdown after the tick
    fixed: list               # bool after the tick
    pose_pos: list            # (1, 3) tensors, the estimate
    pose_quat: list           # (1, 4)
    states: list              # the MCLState after the tick (keep_states)


def run_global_localization(sc: GlobalLocScenario, gl, draws_of=None,
                            inputs_of=None, forced=None,
                            keep_states: bool = False) -> GlobalLocChain:
    """Ticks 1, 2, ... of the scenario through ``gl`` until it is fixed
    or ``sc.ticks`` - 1 ticks ran. Tick t's update draws from
    ``draws_of(t)`` (``pf.MCLDraws`` for ``gl.size`` particles) or from
    ``gl``'s generator; ``inputs_of(t)`` gives its inputs as tensors on
    the device (odom_prev_pos, odom_prev_quat, odom_pos, odom_quat, flat,
    flat_m, sharp, sharp_m), made from :func:`globalloc_inputs` when not
    given; ``forced(t)``, when given, returns an MCLState to put in place
    before tick t, or None (teacher forcing)."""
    dev = gl.device
    dt = torch.tensor(np.float32(GLOBALLOC_DT), device=dev)
    rec = GlobalLocChain([], [], [], [], [], [])
    for t in range(1, sc.ticks):
        if inputs_of is not None:
            x = inputs_of(t)
        else:
            r = globalloc_inputs(sc, t)
            x = {k: torch.as_tensor(r[k], device=dev)
                 for k in ("odom_prev_pos", "odom_pos", "flat", "flat_m",
                           "sharp", "sharp_m")}
            x["odom_prev_quat"] = quat_from_yaw(torch.as_tensor(
                r["odom_prev_yaw"], device=dev))
            x["odom_quat"] = quat_from_yaw(torch.as_tensor(r["odom_yaw"],
                                                           device=dev))
        f = forced(t) if forced is not None else None
        if f is not None:
            gl.state = f
        n = gl.size
        out = gl.step(x["odom_prev_pos"], x["odom_prev_quat"], x["odom_pos"],
                      x["odom_quat"], dt, x["flat"], x["flat_m"], x["sharp"],
                      x["sharp_m"], torch.ones(x["sharp"].shape[0],
                                               device=dev),
                      draws=draws_of(t) if draws_of is not None else None)
        for lst, v in zip(rec, (n, gl.fix_cnt, gl.fixed, out.pose_pos,
                                out.pose_quat,
                                gl.state if keep_states else None)):
            lst.append(v)
        if gl.fixed:
            break
    return rec


# ---------------------------------------------------------------------------
# the config-4 fleet sharded over the ranks of torch.distributed
# ---------------------------------------------------------------------------

def run_sharded_fleet_full_chain(c4: Config4, state, draws_of, ticks: int,
                                 mesh, t0: int = 0, inputs_of=None):
    """``ticks`` chained ticks of ``parallel.fleet.sharded_fleet_full_tick``
    from tick ``t0`` over this rank's block of the fleet (``state`` and
    ``draws_of(t)`` are the whole fleet's; each is cut to the block here,
    as the per-robot inputs are). Returns ({name: (T, B_rank, ...)} for
    every output of the tick's diag, this rank's final state, [found count
    () tensor] per tick)."""
    from dddmr_navigation_tpu_torch.parallel.fleet import (
        shard_fleet_arrays, sharded_fleet_full_tick)
    spec, ri, params = c4.specs
    tick = sharded_fleet_full_tick(c4.cfg, c4.mb, spec, ri, params, mesh,
                                   mcl_cfg=c4.mcl, localize=True)
    b = state.pos.shape[0]
    state, scans, masks, goals = shard_fleet_arrays(
        mesh, (state, c4.scans, c4.masks, c4.goals))
    outs, found = {}, []
    for t in range(t0, t0 + ticks):
        x = inputs_of(t) if inputs_of else config4_tick_inputs(c4, t, b)
        drift, drift_yaw, draws = shard_fleet_arrays(
            mesh, (x["odom_drift_pos"], x["odom_drift_yaw"], draws_of(t)))
        state, diag, n_found = tick(
            c4.fmap, c4.submap, c4.walls, c4.ground, state, scans, masks,
            c4.offset, goals, x["now"], x["dt"], drift, drift_yaw,
            mcl_draws=draws, feature_keys_=c4.keys)
        for k, v in diag.items():
            outs.setdefault(k, []).append(v)
        found.append(n_found)
    return {k: torch.stack(v) for k, v in outs.items()}, state, found


# ---------------------------------------------------------------------------
# SLAM: one mapping run at full width (bench.py::bench_slam's world)
# ---------------------------------------------------------------------------

SLAM_CENTER = (-0.5, -2.0)    # the trajectory circles it counterclockwise
SLAM_RADIUS = 3.0
SLAM_STEP = 0.4               # metres a scan (4 m/s at the 10 Hz sweep)
SLAM_SCANS = 56               # 1.15 laps: back past the start
SLAM_HEIGHT = 0.8             # the lidar above the floor


def slam_world():
    """``bench.py::bench_slam``'s world: a 16 m room with boxes at
    [3.0, -1.5, 0]–[3.6, 0.5, 1.8] and [-2.0, 2.0, 0]–[-1.2, 2.6, 1.4]."""
    return BoxWorld.room(half=8.0) \
        .add_box([3.0, -1.5, 0], [3.6, 0.5, 1.8]) \
        .add_box([-2.0, 2.0, 0], [-1.2, 2.6, 1.4])


def slam_pose(t: int):
    """The true lidar pose at scan ``t``: (position (3,) f32, yaw) on the
    :data:`SLAM_RADIUS` circle around :data:`SLAM_CENTER`, starting at its
    bottom facing +x."""
    yaw = t * SLAM_STEP / SLAM_RADIUS
    return np.array([SLAM_CENTER[0] + SLAM_RADIUS * np.sin(yaw),
                     SLAM_CENTER[1] - SLAM_RADIUS * np.cos(yaw),
                     SLAM_HEIGHT], np.float32), yaw


class SlamScenario(NamedTuple):
    cfg: SlamConfig
    world: BoxWorld
    scans: int                # scans in the run
    true_pos: np.ndarray      # (scans, 3) lidar positions in the world
    true_yaw: np.ndarray      # (scans,)


def slam_scenario(cfg: SlamConfig = None, scans: int = SLAM_SCANS
                  ) -> SlamScenario:
    """A closed loop through :func:`slam_world` at ``SlamConfig()`` (a
    16×1000 range image, 64/512/256/2,048 features, 12 + 6 Gauss-Newton
    iterations, submap pads of 2,048 and 4,096, a 256-keyframe and
    512-edge graph): 1.15 laps of a 3 m circle at 0.4 m a scan, which the
    JAX package's session maps into 20 keyframes and closes four loops
    (keyframes 16-19 against 0-3), ending 0.23 m from the truth."""
    cfg = cfg or SlamConfig()
    poses = [slam_pose(t) for t in range(scans)]
    return SlamScenario(cfg, slam_world(), scans,
                        np.stack([p for p, _ in poses]),
                        np.asarray([y for _, y in poses]))


def slam_scan(sc: SlamScenario, t: int):
    """Scan ``t`` from ``lidar_sim``: (points (N, 3) f32, mask (N,))."""
    return simulate_scan(sc.world, sc.true_pos[t], float(sc.true_yaw[t]),
                         n_rings=sc.cfg.num_vertical_scans,
                         n_cols=sc.cfg.num_horizontal_scans)


def slam_truth(sc: SlamScenario, t: int):
    """Scan ``t``'s true pose in the map frame (the first scan's lidar
    frame): (position (3,), yaw)."""
    y0 = float(sc.true_yaw[0])
    c, s = np.cos(-y0), np.sin(-y0)
    d = sc.true_pos[t] - sc.true_pos[0]
    return np.array([c * d[0] - s * d[1], s * d[0] + c * d[1], d[2]],
                    np.float32), float(sc.true_yaw[t]) - y0


def make_mapping_session(sc: SlamScenario = None, device="cuda"):
    """A ``slam.pipeline.MappingSession`` with the scenario's config (the
    canonical one without a scenario) on ``device``."""
    from dddmr_navigation_tpu_torch.slam.pipeline import MappingSession
    cfg = sc.cfg if sc is not None else SlamConfig()
    return MappingSession(cfg=cfg, device=device)


class MappingChain(NamedTuple):
    """Per-scan records of :func:`run_mapping_chain`."""
    pos: np.ndarray           # (T, 3) the session's pose after each scan
    quat: np.ndarray          # (T, 4)
    keyframes: list           # keyframe count after each scan
    edges: list               # edge count after each scan
    loop_closures: list       # the session's (i, j, fitness) at the end
    scan_s: list              # host seconds a scan
    stage_s: dict             # stage name → host seconds, one per run of it


def run_mapping_chain(sess, sc: SlamScenario, scans_of=None) -> MappingChain:
    """The closed loop: the scenario's scans through ``sess.process_scan``
    (``scans_of(t)`` gives scan t as (points, mask), :func:`slam_scan`
    when not given). Each scan is timed on the host clock, and each stage,
    from its start to the next's (the last to the scan's end), by the
    tracing recorder's stage spans (``time.perf_counter_ns``; a
    :func:`tracing.recording` block: the recorder keeps none of them after
    the run)."""
    pos, quat, kfs, edges, marks = [], [], [], [], []
    with tracing.recording() as kept:
        for t in range(sc.scans):
            pts, mask = scans_of(t) if scans_of else slam_scan(sc, t)
            start = time.perf_counter()
            p, q = sess.process_scan(pts, mask)
            marks.append((start, time.perf_counter()))
            pos.append(np.array(p, np.float32))
            quat.append(np.array(q, np.float32))
            kfs.append(sess.n_keyframes)
            edges.append(sess.n_edges)
    scan_s = [b - a for a, b in marks]
    stage_s = tracing.stage_seconds(kept, "scan")
    return MappingChain(np.stack(pos), np.stack(quat), kfs, edges,
                        list(sess.loop_closures), scan_s, stage_s)


def replay_mapping(sc: SlamScenario, g, scans, device="cuda",
                   scans_of=None) -> dict:
    """The recorded JAX mapping run ``g`` (``testdata/slam_golden.npz``)
    replayed teacher-forced at each scan of ``scans``: the port's session
    is put in the state the JAX session started that scan from
    (``interop.port_mapping_state``, the submap rebuilt from it) and
    processes the scan. Returns {scan: the session after it}; its
    ``last_scan`` holds the stages' outputs."""
    from dddmr_navigation_tpu_torch.interop import (
        port_mapping_state, tick_of)
    keyframes = {k: g[k] for k in g.keys() if k.startswith("kf_")}
    out = {}
    for t in scans:
        state = tick_of(g, t, prefix="state_")
        sess = port_mapping_state(state, sc.cfg, device, keyframes=keyframes)
        pts, mask = scans_of(t) if scans_of else slam_scan(sc, t)
        sess.process_scan(pts, mask)
        out[t] = sess
    return out


SLAM_LOC_TICKS = 10
SLAM_LOC_POINTS = 512         # feature points a class, padded
SLAM_LOC_DT = 0.25


def slam_localization_features(sc: SlamScenario, t: int,
                               n: int = SLAM_LOC_POINTS):
    """Scan ``t``'s features for MCL as ``examples/run_slam_mcl.py``
    splits them: points below -0.4 m in the lidar frame are flat, the
    rest sharp, the first ``n`` of each in scan order. Returns numpy
    (flat (n, 3), flat mask, sharp (n, 3), sharp mask)."""
    pts, mask = slam_scan(sc, t)
    low = pts[:, 2] < -0.4

    def pad(m):
        sel = np.nonzero(m)[0][:n]
        out = np.zeros((n, 3), np.float32)
        out[:len(sel)] = pts[sel]
        keep = np.zeros((n,), bool)
        keep[:len(sel)] = True
        return out, keep
    return (*pad(mask & low), *pad(mask & ~low))


def run_slam_localization(sc: SlamScenario, graph, generators,
                          ticks: int = SLAM_LOC_TICKS, device="cuda",
                          cfg: MCLConfig = None):
    """Localize on a saved map (``submaps.PoseGraph``) along the mapped
    route, the localization pass of ``examples/run_slam_mcl.py``: a
    ``SubmapManager`` over the graph (built once, shared by the passes),
    and for each ``torch.Generator`` of ``generators`` (on ``device``) a
    pass of one filter (B = 1, 48 particles) started at the true start
    (the map origin), odometry equal to the truth, ticks 1..``ticks`` at
    scans 1..``ticks``, its draws from that generator. Returns per pass
    [(tick, xy error m, estimate (3,) numpy)]."""
    from dddmr_navigation_tpu_torch.state_estimation import mcl, pf
    from dddmr_navigation_tpu_torch.state_estimation.submaps import (
        SubmapManager)
    cfg = cfg or MCLConfig(num_particles=48)
    mgr = SubmapManager(graph=graph, cfg=cfg, device=device)
    mgr.initialize([0.0, 0.0, 0.0])

    def pose(t):
        p, yaw = slam_truth(sc, t)
        return (torch.tensor(p[None], device=device),
                quat_from_yaw(torch.tensor([yaw], dtype=torch.float32,
                                           device=device)))
    inputs = [(pose(t - 1), pose(t), [
        torch.tensor(x, device=device)[None]
        for x in slam_localization_features(sc, t)])
        for t in range(1, ticks + 1)]
    dt = torch.tensor(np.float32(SLAM_LOC_DT), device=device)
    weight = torch.ones((1, SLAM_LOC_POINTS), device=device)
    passes = []
    for gen in generators:
        p0, q0 = pose(0)
        state = mcl.init_mcl(cfg, p0, q0, *mcl.init_draws(gen, cfg, 1,
                                                           device))
        out = []
        for t, ((pp, pq), (cp, cq), feats) in enumerate(inputs, 1):
            ctx = mgr.current(cp[0].cpu().numpy())
            state, res = mcl.mcl_update(
                cfg, ctx, state, pp, pq, cp, cq, dt, *feats, weight,
                pf.draw_mcl(gen, 1, cfg.num_particles, device))
            est = res.pose_pos[0].cpu().numpy()
            out.append((t, float(np.linalg.norm(
                est[:2] - cp[0, :2].cpu().numpy())), est))
        passes.append(out)
    return passes


# ---------------------------------------------------------------------------
# semantic segmentation: the 19-class net at full width, the 4-class reroute
# ---------------------------------------------------------------------------

ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts")
SEMANTIC19 = os.path.join(ARTIFACTS, "semantic_ddrnet19.npz")
SEMANTIC4 = os.path.join(ARTIFACTS, "semantic_ddrnet.npz")
SEMANTIC_SEED = 555          # the JAX test's fresh EVAL-family seed
SEMANTIC_FRAMES = 8
REROUTE_SEED = 5
REROUTE_ZONE = (3.5, 0.0, 2.0, 2.0)        # x ∈ [2.5, 4.5], y ∈ [-1, 1]
REROUTE_START = (0.5, 0.0, 0.0)
REROUTE_GOAL = (7.5, 0.0, 0.0)


def load_segmenter(path: str = SEMANTIC19, device="cuda"):
    """(model, params, meta) of a committed segmenter artifact (the JAX
    package's npz and its ``.json`` metadata); the model holds the
    params."""
    with open(path + ".json") as f:
        meta = json.load(f)
    h, w = meta["image_hw"]
    model, template = init_segmenter(h, w, meta["num_classes"],
                                     meta["net_width"], device=device)
    params = load_params(path, template)
    model.load_state_dict(params)
    return model, params, meta


class SemanticScenario(NamedTuple):
    model: DDRNetSlim
    params: dict
    meta: dict
    rgb: np.ndarray       # (N, H, W, 3) f32 EVAL-family frames
    labels: np.ndarray    # (N, H, W) int32 true classes


def semantic_scenario(frames: int = SEMANTIC_FRAMES, device="cuda"):
    """The deployed segmenter at full width: the 19-class artifact (net
    width 48, 240×320, ~1.33 M parameters) and ``frames`` EVAL-family
    frames from the JAX test's seed (``s19.make_batch19``, seed 555), the
    family the artifact never trained on; ``bench.py::bench_semantic``
    times it at batch 1 and 8."""
    model, params, meta = load_segmenter(SEMANTIC19, device)
    h, w = meta["image_hw"]
    rng = np.random.default_rng(SEMANTIC_SEED)
    rgb, labels = s19.make_batch19(rng, frames, h, w, preset=s19.EVAL_PRESET)
    return SemanticScenario(model, params, meta, rgb, labels)


def _reroute_plan(ground, graph, dgraph, device="cuda"):
    """One global plan from :data:`REROUTE_START` to :data:`REROUTE_GOAL`
    on ``ground`` with the node field ``dgraph`` (G,) (the default
    planner, as ``tests/test_semantic_e2e.py`` plans): (ok, node ids)."""
    g = len(ground)
    t = functools.partial(torch.as_tensor, device=device)
    res = plan_on_graph(
        GlobalPlannerConfig(), t(graph.nbr_idx), t(graph.nbr_dist),
        t(graph.nbr_valid), t(ground), t(np.ones(g, bool)),
        dgraph[None], t(np.zeros(g, np.float32)), t(graph.avg_intensity),
        t(np.array([REROUTE_START], np.float32)),
        t(np.array([REROUTE_GOAL], np.float32)),
        inscribed_radius=0.5, inflation_descending_rate=2.0)
    ids = res.node_ids[0][res.node_valid[0]].cpu().numpy()
    return bool(res.ok[0]), ids


def run_semantic_reroute(device="cuda") -> dict:
    """The deployed consumption chain of ``tests/test_semantic_e2e.py``
    (`trt_interface.py` → `semantic_segmentation2point_cloud.cpp` →
    `no_entry_layer.cpp`) on the port's modules, with the 4-class artifact:
    a camera sees a forbidden (grass) zone across the robot's path
    (``render_scene``, seed 5, zone :data:`REROUTE_ZONE`); its class mask →
    the class-2 point cloud → world frame → the no-entry field on a 16×8 m
    floor → the global plan, which must bend around the zone.

    Returns ``pred`` (H, W) int32, the world points of class 2 (``zone``)
    and which of them lie in the true zone (``in_zone``), the field
    (``field``), and both plans (``ok_free``/``ids_free`` with no field,
    ``ok_zone``/``ids_zone`` with it) with ``ground``."""
    model, params, _ = load_segmenter(SEMANTIC4, device)
    cam = CameraIntrinsics()
    rng = np.random.default_rng(REROUTE_SEED)
    rgb, depth, _, _, (origin, pitch) = render_scene(
        rng, cam, n_boxes=0, zones=[REROUTE_ZONE], pitch_jitter=0.0)
    pred = infer_classes(model, params,
                         torch.as_tensor(rgb[None], device=device))[0]
    cloud, valid = segmentation_to_pointcloud(
        torch.as_tensor(depth, device=device), pred, cam.fx, cam.fy, cam.cx,
        cam.cy, keep_classes=[2])
    pts_cam = cloud[valid][:, :3].cpu().numpy()
    zone = camera_to_world(pts_cam, origin, pitch)
    cx, cy, sx, sy = REROUTE_ZONE
    in_zone = ((np.abs(zone[:, 0] - cx) <= sx / 2 + 0.4)
               & (np.abs(zone[:, 1] - cy) <= sy / 2 + 0.4)
               & (np.abs(zone[:, 2]) <= 0.2))
    ground = flat_ground_map(16, 8, 0.25)
    ground[:, 0] += 7.0                  # x ∈ [-1, 15]
    g = len(ground)
    zone_pts = torch.as_tensor(zone[in_zone].astype(np.float32),
                               device=device)
    field = no_entry_dgraph(
        torch.as_tensor(ground, device=device),
        torch.ones(g, dtype=torch.bool, device=device), zone_pts,
        torch.ones(len(zone_pts), dtype=torch.bool, device=device),
        inflation_distance=1.0, max_obstacle_distance=9999.0)
    graph = build_ground_graph(ground, radius=0.5, k_max=16)
    ok_free, ids_free = _reroute_plan(
        ground, graph, torch.full((g,), 9999.0, device=device), device)
    ok_zone, ids_zone = _reroute_plan(ground, graph, field, device)
    return {"pred": pred.cpu().numpy(), "zone": zone, "in_zone": in_zone,
            "field": field.cpu().numpy(), "ground": ground,
            "ok_free": ok_free, "ids_free": ids_free,
            "ok_zone": ok_zone, "ids_zone": ids_zone}


def reroute_bend(ground, ids) -> float:
    """The largest |y| of a plan's nodes inside x ∈ (2, 5), where the zone
    crosses the straight route (0 when the plan has none there)."""
    p = ground[ids]
    mid = (p[:, 0] > 2.0) & (p[:, 0] < 5.0)
    return float(np.abs(p[mid, 1]).max()) if mid.any() else 0.0


def session_checkpoint_round_trip(sc: SessionScenario, directory: str,
                                  ticks: int = 4, device="cuda") -> dict:
    """A mid-run checkpoint of the session through
    ``runtime.CheckpointManager``: two sessions run the scenario's first
    ``ticks`` ticks in lockstep; the first's ``checkpoint_state()`` is saved,
    the second's device state is overwritten with a fresh session's, then
    restored from the saved file; both tick once more on the same inputs.

    Returns the step restored, both sessions' last tick (``out_a``,
    ``out_b``: vx, wz, decision, done, succeeded), and ``same_state``
    (every checkpointed tensor equal after the restore)."""
    from dddmr_navigation_tpu_torch.runtime.checkpoint import (
        CheckpointManager, tree_flatten)
    a, b = make_session(sc, device), make_session(sc, device)
    for s in (a, b):
        s.set_goal(sc.goal)
    pos, yaw, v, w = sc.start.copy(), 0.0, 0.0, 0.0

    def tick(t):
        pts, mask, quat, frames = session_inputs(sc, pos, yaw)
        outs = []
        for s in (a, b):
            for c, (cp, cq, dp) in enumerate(frames):
                s.push_depth_observation(c, cp, cq, dp, t * SESSION_DT)
            outs.append(s.tick(pts, mask, pos, quat, v, w, t * SESSION_DT))
        return outs

    for t in range(ticks):
        out_a, _ = tick(t)
        v, w = out_a[0], out_a[1]
        pos, yaw = step_pose(pos, yaw, v, w)
    mgr = CheckpointManager(directory, keep=2)
    mgr.save(ticks, a.checkpoint_state())
    b.restore_state(make_session(sc, device).checkpoint_state())
    step, state = mgr.restore_latest(b.checkpoint_state())
    b.restore_state(state)
    la, _ = tree_flatten(a.checkpoint_state())
    lb, _ = tree_flatten(b.checkpoint_state())
    same = len(la) == len(lb) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y
        for x, y in zip(la, lb))
    out_a, out_b = tick(ticks)
    return {"step": step, "out_a": out_a, "out_b": out_b,
            "same_state": same}


def semantic_train_task():
    """The JAX package's train test's synthetic task
    (``tests/test_perception_layers.py``: class = brightness band of the
    input, 4 frames of 32×32, 3 classes): (rgb (4, 32, 32, 3) f32, labels
    (4, 32, 32) int32)."""
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    labels = (rgb.mean(-1) * 3).astype(np.int32).clip(0, 2)
    return rgb, labels


# ---------------------------------------------------------------------------
# mark/clear: the CUDA graph against the eager step
# ---------------------------------------------------------------------------

class MarkClearScenario(NamedTuple):
    spec: object              # perception.voxel.VoxelSpec
    ri: object                # perception.fov.RangeImageSpec
    params: object            # perception.marking.MarkingParams
    ground: np.ndarray        # (G, 3) the floor's ground nodes
    walls: np.ndarray         # (M, 3) the static map's points
    # per tick (scan_pts (B, N, 3), scan_mask (B, N), robot_pos (B, 3),
    # robot_quat (B, 4), sensor_pos (B, 3), sensor_quat (B, 4)), numpy
    ticks: list


def mark_clear_scenario(robots: int = 1, pool: int = 1,
                        ticks: int = 12) -> MarkClearScenario:
    """``robots`` robots driving and turning past two boxes on a 4 × 4 m
    floor, at a 32 × 32 × 16 window of 0.05 m (``pool`` > 1 clusters on
    the pooled lattice): each tick a scan of the boxes and the floor, a
    different share of it dropped every other tick so that marked cells
    are also cleared."""
    from dddmr_navigation_tpu_torch.perception.fov import RangeImageSpec
    from dddmr_navigation_tpu_torch.perception.marking import MarkingParams
    from dddmr_navigation_tpu_torch.perception.voxel import VoxelSpec
    spec = VoxelSpec(32, 32, 16, 0.05, 0.05)
    ri = RangeImageSpec(rows=16, cols=360, elev_min_deg=-15.0,
                        elev_max_deg=15.0)
    params = MarkingParams(
        scan_effective_positive_start=0.0, scan_effective_negative_start=0.0,
        segmentation_ignore_ratio=0.5, max_marked_voxels=256,
        max_window_nodes=512, cluster_pool=pool)
    ground = flat_ground_map(4, 4, 0.25)
    walls = box_obstacle([1.2, 0.8, 0.0], size=(0.3, 0.3, 0.6))
    cloud = np.concatenate([
        box_obstacle([0.5, 0.2, 0.1], size=(0.2, 0.4, 0.25), resolution=0.04),
        box_obstacle([-0.3, -0.5, 0.0], size=(0.3, 0.2, 0.4),
                     resolution=0.04),
        np.stack(np.meshgrid(np.arange(-1.5, 1.5, 0.1),
                             np.arange(-1.5, 1.5, 0.1), [-0.02],
                             indexing="ij"), -1).reshape(-1, 3),
    ]).astype(np.float32)
    n = 1024
    b_idx = np.arange(robots, dtype=np.float32)
    out = []
    for k in range(ticks):
        pos = np.stack([-0.2 + 0.1 * b_idx + 0.06 * k,
                        0.05 * b_idx - 0.03 * k,
                        np.zeros(robots, np.float32)], 1).astype(np.float32)
        yaw = (0.1 * k * (1 - 2 * (b_idx % 2)) + 0.3 * b_idx).astype(
            np.float32)
        quat = np.stack([np.zeros_like(yaw), np.zeros_like(yaw),
                         np.sin(yaw / 2), np.cos(yaw / 2)], 1)
        pts = np.zeros((robots, n, 3), np.float32)
        mask = np.zeros((robots, n), bool)
        for b in range(robots):
            keep = np.random.default_rng([k, b]).uniform(
                size=len(cloud)) < (0.9 if k % 2 == 0 else 0.4)
            sel = cloud[keep][:n]
            pts[b, :len(sel)] = sel
            mask[b, :len(sel)] = True
        sensor = pos + np.array([0.0, 0.0, 0.25], np.float32)
        out.append((pts, mask, pos, quat.astype(np.float32), sensor,
                    quat.astype(np.float32)))
    return MarkClearScenario(spec, ri, params, ground, walls, out)


def run_mark_clear_pair(sc: MarkClearScenario, map_ctx, device) -> dict:
    """The scenario's ticks through ``perception_update`` (a CUDA graph on
    the card) with the recorder on, and from each tick's same start state
    through its eager body. Returns {"mismatch": [(tick, field)] where the
    two differ in a bit, "aliased": [ticks t whose kept state changed in
    tick t + 1], "captures" / "replays": the graphs' counts over the
    run, "counters": the recorder's, "eager_counts": the eager body's
    marked cells seen and kept, summed}."""
    from dddmr_navigation_tpu_torch.perception import marking
    graphs = marking.MARK_CLEAR_GRAPHS
    c0, r0 = graphs.captures, graphs.replays
    dev = torch.device(device)
    ticks = [tuple(torch.as_tensor(a, device=dev) for a in tick)
             for tick in sc.ticks]
    state = marking.init_marking_state(sc.spec, sc.params, len(sc.ground),
                                       ticks[0][2])
    fields = ("grid", "origin", "dgraph", "clear_offset")
    mismatch, aliased, seen, kept = [], [], 0, 0
    prev = None
    with tracing.recording():
        before = tracing.counters()
        for t, (pts, mask, pos, quat, spos, squat) in enumerate(ticks):
            eager = marking._perception_step(
                sc.spec, sc.ri, sc.params, map_ctx, *state, pts, mask, pos,
                quat, spos, squat)
            seen, kept = seen + int(eager[4]), kept + int(eager[5])
            state = marking.perception_update(
                sc.spec, sc.ri, sc.params, state, map_ctx, pts, mask, pos,
                quat, spos, squat)
            mismatch += [(t, f) for f, a, b in zip(fields, state, eager)
                         if not torch.equal(a, b)]
            if prev is not None and not all(
                    torch.equal(a, b) for a, b in zip(*prev[1:])):
                aliased.append(prev[0])
            prev = (t, state, [x.clone() for x in state])
        after = tracing.counters()
    counters = {k: v - before.get(k, 0) for k, v in after.items()}
    return {"mismatch": mismatch, "aliased": aliased,
            "captures": graphs.captures - c0, "replays": graphs.replays - r0,
            "counters": counters, "eager_counts": (seen, kept)}
