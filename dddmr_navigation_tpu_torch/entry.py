"""Entry points of the port's local-planner slice.

* :func:`entry` — the counterpart of ``__graft_entry__.entry()``: one
  single-robot control tick (B = 1) and its example arguments.
* :func:`headline_config` / :func:`headline_inputs` — the 64-robot fleet of
  ``bench.py::bench_headline``: 16×16 dynamic window (289 padded samples),
  40 steps, 512 obstacles per robot, near-K 128, the same seeds, plans and
  obstacles.
* :func:`tick` / :func:`run_chain` — fleet ticks chained through
  ``integrate_fleet``, as the headline's 50-tick chain runs them.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dddmr_navigation_tpu.config import (
    DDSimpleGeneratorConfig, LocalPlannerConfig, NavigationConfig)
from dddmr_navigation_tpu_torch.geometry import quat_from_yaw
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


def entry(device="cpu"):
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


def headline_inputs(cfg: LocalPlannerConfig, robots: int = 64, device="cpu"):
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
