"""Global-plan managers: the move-base side of plan querying (counterpart
of ``dddmr_navigation_tpu/control/plan_manager.py``,
`P2PGlobalPlanManager`, `p2p_global_plan_manager.cpp`).

A query timer at ``query_frequency`` (5 Hz) sends GetPlan goals to the
plain planner ("get_plan") or the DWA planner ("get_dwa_plan"); ``stop()``
halts the timer and stops the DWA recompute too (`:83-106`);
``take_plan()`` hands the freshest path to the control loop once
(`:174-186`).

:class:`SyncPlanManager` queries inline when the timer elapses. Its state
between ticks is a :class:`PlanManagerState` (:meth:`state`,
:meth:`load`), its DWA manager's inside it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from navbench.reference.planning.global_.dwa import (
    CachedPlan, DWAGlobalPlanManager, DWAState, to_arrays, to_tensors)


class PlanManagerState(NamedTuple):
    """What a :class:`SyncPlanManager` carries from tick to tick."""
    goal_pos: Optional[torch.Tensor]     # (3,) CPU, None before a goal
    goal_quat: Optional[torch.Tensor]    # (4,) CPU
    active: bool                         # the query timer runs
    last_query_t: float
    plan: Optional[CachedPlan]           # the freshest path, CPU tensors
    fresh: bool                          # not yet taken
    empty_result: bool                   # the last query found no path
    dwa: DWAState


class SyncPlanManager:
    """Inline plan querying at ``query_frequency`` over a DWA manager.
    ``action`` (`p2p_global_plan_manager.cpp:45-47`): "get_dwa_plan"
    (default) uses the DWA cache and splice; "get_plan" replans in full
    from the robot on every query."""

    def __init__(self, dwa: DWAGlobalPlanManager, query_frequency: float,
                 action: str = "get_dwa_plan"):
        self.dwa = dwa
        self.action = action
        self.query_frequency = query_frequency
        self.goal: Optional[tuple] = None
        self.active = False
        self._last_query_t = -1e9
        self._plan: Optional[CachedPlan] = None
        self._fresh = False
        self._empty_result = False

    def state(self) -> PlanManagerState:
        goal = self.goal or (None, None)
        return PlanManagerState(
            goal_pos=to_tensors(goal[0]), goal_quat=to_tensors(goal[1]),
            active=self.active, last_query_t=self._last_query_t,
            plan=to_tensors(self._plan), fresh=self._fresh,
            empty_result=self._empty_result, dwa=self.dwa.state())

    def load(self, s: PlanManagerState):
        """Put back a :meth:`state` (its arrays shared, never written)."""
        self.goal = (None if s.goal_pos is None else
                     (to_arrays(s.goal_pos), to_arrays(s.goal_quat)))
        self.active = s.active
        self._last_query_t = s.last_query_t
        self._plan = to_arrays(s.plan)
        self._fresh = s.fresh
        self._empty_result = s.empty_result
        self.dwa.load(s.dwa)

    def set_goal(self, goal_pos, goal_quat):
        self.goal = (np.asarray(goal_pos, np.float32),
                     np.asarray(goal_quat, np.float32))
        self._plan = None
        self._fresh = False
        self.resume()

    def resume(self):
        self.active = True

    def stop(self):
        """Halt querying, and the DWA recompute with it
        (`activate_threading=false`, `:96-105`)."""
        self.active = False
        self.dwa.threading_active = False

    def has_plan(self) -> bool:
        return self._fresh

    def take_plan(self) -> Optional[CachedPlan]:
        """copyPlan: hand over the freshest plan once."""
        if not self._fresh:
            return None
        self._fresh = False
        return self._plan

    def last_query_empty(self) -> bool:
        return self._empty_result

    def _query(self, robot_pos, dgraph, now, lethal_pts, lethal_valid,
               goal, recompute: bool):
        """One GetPlan query (and, with ``recompute``, the DWA recompute
        first). Returns the path or None."""
        gp, gq = goal
        if self.action == "get_dwa_plan":
            if recompute:
                self.dwa.maybe_recompute(robot_pos, dgraph, now,
                                         lethal_pts=lethal_pts,
                                         lethal_valid=lethal_valid)
            return self.dwa.request(gp, gq, robot_pos, dgraph,
                                    lethal_pts=lethal_pts,
                                    lethal_valid=lethal_valid)
        full = self.dwa.rt.plan(robot_pos, gp, dgraph, lethal_pts=lethal_pts,
                                lethal_valid=lethal_valid)
        return None if full is None else CachedPlan(*full)

    def offer(self, robot_pos, dgraph, now, lethal_pts=None,
              lethal_valid=None):
        """Called every control tick with the live snapshot."""
        if not (self.active and self.goal is not None):
            return
        if self.action == "get_dwa_plan":
            # the windowed recompute rides its own (10 Hz) timer
            self.dwa.maybe_recompute(robot_pos, dgraph, now,
                                     lethal_pts=lethal_pts,
                                     lethal_valid=lethal_valid)
        if now - self._last_query_t < 1.0 / self.query_frequency:
            return
        self._last_query_t = now
        path = self._query(robot_pos, dgraph, now, lethal_pts, lethal_valid,
                           self.goal, recompute=False)
        self._empty_result = path is None
        if path is not None:
            self._plan = path
            self._fresh = True
