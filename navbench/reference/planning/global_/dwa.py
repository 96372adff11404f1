"""Dynamic-window-aware global planning: full plan, windowed replan and
splice (counterpart of ``dddmr_navigation_tpu/planning/global_/dwa.py``,
`DWA_GlobalPlanner`, `dynamic_window_aware_global_planner.cpp:100-288`).

* :meth:`DWAGlobalPlanManager.request` is `makePlan`: a new goal (exact
  pose equality, `:115-131`) triggers a full plan, which is cached; a stale
  goal returns the cached spliced path (`:183-189`);
  ``activate_threading=False`` stops the recompute timer (`:146-151`).
* :meth:`DWAGlobalPlanManager.maybe_recompute` is `determineDWAPlan`
  (`:192-288`) at ``recompute_frequency``: from the cached path's pose
  nearest the robot walk ``look_ahead_distance`` of arc, +1 m while the
  tentative local goal is blocked (no ground within 0.25 m, or a lethal
  ground node within 0.25 m), plan robot → local goal and splice the
  cached tail on. The final pose is appended twice, as the reference does
  (`:285-286`).

:func:`dwa_pivot` is the blocked walk on the device, batched over robots:
one (P, G) plan × ground distance matrix and every +1 m shift at once.

The manager's state between ticks is a :class:`DWAState` (its cached
paths as CPU tensors): :meth:`DWAGlobalPlanManager.state` reads it and
:meth:`DWAGlobalPlanManager.load` puts it back.

Rounding: the JAX package jits :func:`dwa_pivot`, so its norms and its
Precision.HIGHEST (P, 3) × (3, G) product are FMA chains
(``rounding.fma_dot``; no matmul, so TF32 never applies) and its cumsum is
XLA's blocked scan (``rounding.cumsum_xla``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from navbench.reference.config import DWAGlobalPlannerConfig
from navbench.reference.rounding import cumsum_xla, fma_dot, fma_norm


def dwa_pivot(plan_pos, plan_valid, robot_pos, ground, ground_valid, dgraph,
              *, look_ahead_distance: float, inscribed_radius: float,
              max_shifts: int = 100, ground_match_radius: float = 0.25):
    """Index into each cached plan of its DWA local goal: from the plan
    pose nearest the robot advance ``look_ahead_distance`` of arc, then
    shift forward in +1 m steps while the tentative goal is blocked; the
    path's end is always acceptable.

    plan_pos (B, P, 3), plan_valid (B, P), robot_pos (B, 3), ground (G, 3),
    ground_valid (G,), dgraph (B, G). Returns (pivot (B,), nearest (B,))."""
    b, p, _ = plan_pos.shape
    dev = plan_pos.device
    d = fma_norm(plan_pos - robot_pos[:, None, :])
    i0 = torch.argmin(torch.where(plan_valid, d, torch.inf), dim=1)

    seg = fma_norm(plan_pos[:, 1:] - plan_pos[:, :-1])
    seg = torch.where(plan_valid[:, 1:] & plan_valid[:, :-1], seg, 0.0)
    cum = torch.cat([torch.zeros((b, 1), device=dev), cumsum_xla(seg)], 1)
    last = torch.clamp(plan_valid.sum(dim=1) - 1, min=0)

    # per-plan-pose blocked flags from one (P, G) distance matrix
    gp = torch.where(ground_valid[:, None], ground, 1e6)
    a2 = fma_dot(plan_pos, plan_pos)                             # (B, P)
    b2 = fma_dot(gp, gp)                                         # (G,)
    cross = fma_dot(plan_pos[:, :, None, :], gp[None, None])     # (B, P, G)
    d2 = (a2[:, :, None] + b2) - 2.0 * cross
    near = d2 <= ground_match_radius ** 2
    no_ground = ~near.any(dim=2)
    lethal_near = (near & (dgraph[:, None, :] < inscribed_radius)).any(dim=2)
    blocked = (no_ground | lethal_near) & plan_valid

    # every +1 m shift at once
    shifts = torch.arange(max_shifts, dtype=torch.float32, device=dev)
    targets = (cum.gather(1, i0[:, None]) + look_ahead_distance) + shifts
    idx = torch.minimum(torch.searchsorted(cum.contiguous(), targets),
                        last[:, None])
    ok = (idx >= last[:, None]) | ~blocked.gather(1, idx)
    first = torch.argmax(ok.int(), dim=1)
    pivot = torch.where(ok.any(dim=1), idx.gather(1, first[:, None])[:, 0],
                        last)
    return pivot, i0


class CachedPlan(NamedTuple):
    positions: np.ndarray     # (M, 3); CPU tensors inside a state tree
    quats: np.ndarray         # (M, 4)


def to_tensors(x):
    """A host value of a state tree: None as is, a numpy array (or each
    array of a :class:`CachedPlan`) as a CPU tensor sharing its memory."""
    if x is None:
        return None
    if isinstance(x, CachedPlan):
        return CachedPlan(*(torch.from_numpy(a) for a in x))
    return torch.from_numpy(x)


def to_arrays(x):
    """The inverse of :func:`to_tensors`."""
    if x is None:
        return None
    if isinstance(x, CachedPlan):
        return CachedPlan(*(t.numpy() for t in x))
    return x.numpy()


class DWAState(NamedTuple):
    """What a :class:`DWAGlobalPlanManager` carries from tick to tick."""
    goal_pos: Optional[torch.Tensor]     # (3,) CPU, None before a plan
    goal_quat: Optional[torch.Tensor]    # (4,) CPU
    global_path: Optional[CachedPlan]    # the full plan, CPU tensors
    dwa_path: Optional[CachedPlan]       # the spliced window replan
    threading_active: bool               # the recompute timer runs
    last_recompute_t: float


class DWAGlobalPlanManager:
    """Host-side DWA planner state machine over a ``GlobalPlannerRuntime``
    (one robot)."""

    def __init__(self, runtime, dwa_cfg: DWAGlobalPlannerConfig):
        self.rt = runtime
        self.cfg = dwa_cfg
        self.current_goal = None          # (pos (3,), quat (4,)) numpy
        self.global_path: Optional[CachedPlan] = None
        self.dwa_path: Optional[CachedPlan] = None
        self.threading_active = False
        self.last_recompute_t = -1e9
        self.last_pivot = -1              # the last recompute's pivot index

    def state(self) -> DWAState:
        goal = self.current_goal or (None, None)
        return DWAState(
            goal_pos=to_tensors(goal[0]), goal_quat=to_tensors(goal[1]),
            global_path=to_tensors(self.global_path),
            dwa_path=to_tensors(self.dwa_path),
            threading_active=self.threading_active,
            last_recompute_t=self.last_recompute_t)

    def load(self, s: DWAState):
        """Put back a :meth:`state` (its arrays shared, never written)."""
        self.current_goal = (None if s.goal_pos is None else
                             (to_arrays(s.goal_pos), to_arrays(s.goal_quat)))
        self.global_path = to_arrays(s.global_path)
        self.dwa_path = to_arrays(s.dwa_path)
        self.threading_active = s.threading_active
        self.last_recompute_t = s.last_recompute_t

    def _is_new_goal(self, goal_pos, goal_quat) -> bool:
        if self.current_goal is None:
            return True
        p, q = self.current_goal
        return not (np.array_equal(p, goal_pos)
                    and np.array_equal(q, goal_quat))

    def request(self, goal_pos, goal_quat, robot_pos, dgraph,
                activate_threading: bool = True,
                lethal_pts=None, lethal_valid=None) -> Optional[CachedPlan]:
        """`makePlan`. Returns the path to hand the controller, or None
        (planning failed and nothing is cached)."""
        goal_pos = np.asarray(goal_pos, np.float32)
        goal_quat = np.asarray(goal_quat, np.float32)
        if not activate_threading:
            self.threading_active = False
            return self.dwa_path or self.global_path
        if self._is_new_goal(goal_pos, goal_quat):
            full = self.rt.plan(robot_pos, goal_pos, dgraph,
                                lethal_pts=lethal_pts,
                                lethal_valid=lethal_valid)
            if full is None:
                return None
            self.current_goal = (goal_pos, goal_quat)
            self.global_path = CachedPlan(*full)
            self.dwa_path = None
            self.threading_active = True
            return self.global_path
        return self.dwa_path or self.global_path

    def maybe_recompute(self, robot_pos, dgraph, now: float,
                        lethal_pts=None, lethal_valid=None):
        """`determineDWAPlan` when the recompute timer has elapsed. Returns
        the current best path."""
        if (self.threading_active and self.global_path is not None
                and now - self.last_recompute_t
                >= 1.0 / self.cfg.recompute_frequency):
            self.last_recompute_t = now
            self._recompute(robot_pos, dgraph, lethal_pts, lethal_valid)
        return self.dwa_path or self.global_path

    def _recompute(self, robot_pos, dgraph, lethal_pts, lethal_valid):
        gp = self.global_path
        n = len(gp.positions)
        max_len = self.rt.cfg.max_path_len
        take = min(n, max_len)
        pos_pad = np.zeros((1, max_len, 3), np.float32)
        pos_pad[0, :take] = gp.positions[:take]
        valid = np.zeros((1, max_len), bool)
        valid[0, :take] = True
        dev = self.rt.device
        pivot, _ = dwa_pivot(
            torch.as_tensor(pos_pad, device=dev),
            torch.as_tensor(valid, device=dev),
            torch.as_tensor(robot_pos, dtype=torch.float32,
                            device=dev).reshape(1, 3),
            self.rt.ground_dev, self.rt.ground_valid_dev,
            torch.as_tensor(dgraph, device=dev).reshape(1, -1),
            look_ahead_distance=self.cfg.look_ahead_distance,
            inscribed_radius=self.rt.inscribed_radius)
        pivot = self.last_pivot = int(pivot[0])
        local_goal = gp.positions[min(pivot, take - 1)]
        window = self.rt.plan(robot_pos, local_goal, dgraph,
                              lethal_pts=lethal_pts,
                              lethal_valid=lethal_valid)
        if window is None:
            return  # keep the previous cache, as the reference does
        wpos, wquat = window
        pos = np.concatenate([wpos, gp.positions[pivot:], gp.positions[-1:]])
        quat = np.concatenate([wquat, gp.quats[pivot:], gp.quats[-1:]])
        self.dwa_path = CachedPlan(pos.astype(np.float32),
                                   quat.astype(np.float32))
