"""Global localization: recover the pose from an unknown start.

Counterpart of ``dddmr_navigation_tpu/state_estimation/global_localization.py``,
the reference's particle-overflow machinery (`mcl_3dl.cpp:661-679` +
`pf.h:387-430` resizeParticle): while the filter carries MORE than
``num_particles`` particles, every ``shrink_every``-th measurement tick
shrinks the set by ×0.75 (systematic resampling, so mass concentrates on
well-matching hypotheses), and once the runtime size is reached a fix
countdown of ``1 + ceil(lpf_step)·3`` ticks (three LPF sigmas) must drain
before the estimate is declared fixed.

The seed spreads ``num_start`` particles over the ground nodes × a yaw
grid; ticks run with ``global_mode=True`` (uniform bias, LPF resets) until
the runtime size is reached. One robot, as a fleet of B = 1: the filter is
the port's batched MCL. The particle count is a shape and the shrink
schedule and countdown are host integers, so a tick reads nothing back
from the device. Every draw is a tensor: the seed's node and yaw indices
and each update's ``pf.MCLDraws`` come from an explicit
``torch.Generator``, or are passed in (a replay of another generator's).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from dddmr_navigation_tpu_torch.config import MCLConfig
from dddmr_navigation_tpu_torch.rounding import fma
from dddmr_navigation_tpu_torch.state_estimation import pf as pflib
from dddmr_navigation_tpu_torch.state_estimation.mcl import (
    MCLOutput, MCLState, lpf_set, mcl_update)


class SeedDraws(NamedTuple):
    """The seed's draws: per particle a ground node and a yaw-grid cell."""
    node_idx: torch.Tensor     # (N,) int64 in [0, G)
    yaw_idx: torch.Tensor      # (N,) int64 in [0, yaw_samples)


def draw_seed(generator: torch.Generator, num_start: int, num_nodes: int,
              yaw_samples: int, device) -> SeedDraws:
    """The seed's draws from ``generator`` (which lives on ``device``)."""
    return SeedDraws(
        node_idx=torch.randint(0, num_nodes, (num_start,),
                               generator=generator, device=device),
        yaw_idx=torch.randint(0, yaw_samples, (num_start,),
                              generator=generator, device=device))


def yaw_grid(yaw_samples: int, device) -> torch.Tensor:
    """``jnp.linspace(-π, π, yaw_samples, endpoint=False)`` rounded as XLA
    on the CPU rounds it: start·(1 - h) + i·(stop/n) with h = i·(1/n), the
    second product fused into the sum. Up to 32 cells LLVM unrolls the
    loop and folds 1·x at i = 1, which fuses the first product instead.
    Bit-equal to JAX for every size from 2 to 79."""
    inv = float(np.float32(1.0) / np.float32(yaw_samples))
    i = torch.arange(yaw_samples, dtype=torch.float32, device=device)
    start, stop = float(np.float32(-np.pi)), float(np.float32(np.pi))
    step = float(np.float32(stop) * np.float32(inv))
    one_minus_h = 1.0 - i * inv
    grid = fma(i, step, start * one_minus_h)
    if 1 < yaw_samples <= 32:
        grid[1] = fma(start, one_minus_h[1], step)
    return grid


def seed_global_state(cfg: MCLConfig, ground_pts, draws: SeedDraws,
                      z_offset: float = 0.0,
                      yaw_samples: int = 8) -> MCLState:
    """The big-N seed as a fleet of one (B = 1): a particle at each drawn
    ground node (``ground_pts`` (G, 3) on the draws' device) with the
    drawn cell of a uniform yaw grid."""
    dev = draws.node_idx.device
    yaws = yaw_grid(yaw_samples, dev)[draws.yaw_idx]
    pos = ground_pts[draws.node_idx] + torch.tensor(
        [0.0, 0.0, z_offset], dtype=torch.float32, device=dev)
    particles = pflib.seed_particles_at(pos[None], yaws[None])
    center = pos.mean(dim=0, keepdim=True)
    idq = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=dev)
    return MCLState(
        particles=particles, state_prev_pos=center, state_prev_quat=idq,
        f_pos=lpf_set(cfg.lpf_step, center),
        f_ang=lpf_set(cfg.lpf_step, torch.zeros((1, 3), device=dev)))


class GlobalLocalization:
    """Feed odometry and feature scans tick by tick; ``fixed`` turns True
    once the shrink schedule lands on the runtime particle count and the
    three-sigma countdown drains. The converged :class:`MCLState` (B = 1,
    ``cfg.num_particles`` particles) is the handoff to the runtime
    filter."""

    def __init__(self, cfg: MCLConfig, ctx, ground_pts,
                 num_start: int | None = None, z_offset: float = 0.0,
                 yaw_samples: int = 16, shrink_every: int = 1,
                 generator: Optional[torch.Generator] = None,
                 seed_draws: Optional[SeedDraws] = None, device="cuda"):
        """``ground_pts`` (G, 3) array-like; ``generator`` (on ``device``)
        makes the seed's draws, unless ``seed_draws`` gives them, and
        each update's, unless :meth:`step` is given them. ``yaw_samples``
        sets the seed's yaw grid (the likelihood's yaw basin is a few
        tenths of a radian, so ≥ 16 is advised); ``shrink_every`` spaces
        the ×0.75 shrinks over that many ticks (the reference shrinks per
        motion-gated measure, `mcl_3dl.cpp:196,661`)."""
        self.cfg = cfg
        self.ctx = ctx
        self.device = torch.device(device)
        self.generator = generator
        ground = torch.as_tensor(np.asarray(ground_pts, np.float32),
                                 device=self.device)
        n0 = num_start or cfg.num_particles * 16
        if seed_draws is None:
            if generator is None:
                raise ValueError("global localization needs a generator or "
                                 "the seed's draws")
            seed_draws = draw_seed(generator, n0, ground.shape[0],
                                   yaw_samples, self.device)
        self.state = seed_global_state(cfg, ground, seed_draws,
                                       z_offset=z_offset,
                                       yaw_samples=yaw_samples)
        self.fix_cnt = 0
        self.shrink_every = max(int(shrink_every), 1)
        self._ticks_since_shrink = 0

    @property
    def size(self) -> int:
        return self.state.particles.prob.shape[1]

    @property
    def fixed(self) -> bool:
        return self.size <= self.cfg.num_particles and self.fix_cnt == 0

    def step(self, odom_prev_pos, odom_prev_quat, odom_pos, odom_quat, dt,
             flat_pts, flat_mask, sharp_pts, sharp_mask, sharp_weight,
             draws: Optional[pflib.MCLDraws] = None) -> MCLOutput:
        """One measurement tick and the shrink schedule. Odometry (3,)/(4,)
        now and before, ``dt`` a () tensor, one scan's feature clouds
        (F, 3)/(S, 3) with masks and the sharp weights (S,), all on the
        device; ``draws`` the update's (B = 1, N = :attr:`size`), drawn
        from the generator when not given. Returns the MCLOutput (B = 1)."""
        n = self.size
        if draws is None:
            if self.generator is None:
                raise ValueError("no draws given and no generator to make "
                                 "them")
            draws = pflib.draw_mcl(self.generator, 1, n, self.device)
        self.state, out = mcl_update(
            self.cfg, self.ctx, self.state, odom_prev_pos[None],
            odom_prev_quat[None], odom_pos[None], odom_quat[None], dt,
            flat_pts[None], flat_mask[None], sharp_pts[None],
            sharp_mask[None], sharp_weight[None], draws,
            global_mode=n > self.cfg.num_particles)
        self._ticks_since_shrink += 1
        if (n > self.cfg.num_particles
                and self._ticks_since_shrink >= self.shrink_every):
            self._ticks_since_shrink = 0
            reduced = int(n * 0.75)
            target = max(reduced, self.cfg.num_particles)
            self.state = self.state._replace(particles=pflib.resize_particles(
                self.state.particles, target))
            # three-sigma LPF settle (`mcl_3dl.cpp:674`)
            self.fix_cnt = 1 + int(math.ceil(self.cfg.lpf_step)) * 3
        elif self.fix_cnt:
            self.fix_cnt -= 1
        return out
