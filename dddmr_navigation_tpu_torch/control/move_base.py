"""The p2p move-base driver: goal → plan → control loop → cmd_vel, for one
robot (counterpart of ``dddmr_navigation_tpu/control/move_base.py``, the
reference's `P2PMoveBase` and `P2PGlobalPlanManager`,
`p2p_move_base.cpp`, `p2p_global_plan_manager.cpp`).

Host sequencing around the device functions, with B = 1 inside: global
plan queries through a :class:`SyncPlanManager` or
:class:`AsyncPlanManager` (DWA windowed replans included), the local
planner with the generator the FSM selects, the path-blocked override, the
FSM step, the rotate recovery, and the host failure gates (sensor
freshness ⇒ PERCEPTION_MALFUNCTION, TF age ⇒ TF_FAIL,
`local_planner.cpp:482-524`).

The tick reads the device once, after the FSM: decision, command source,
done, succeeded and the recovery request, with both commands.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dddmr_navigation_tpu_torch.config import NavigationConfig
from dddmr_navigation_tpu_torch.geometry import yaw_from_quat
from dddmr_navigation_tpu_torch.planning.local.planner import (
    GlobalPlan, PlannerState, compute_velocity_command, goal_heading_deviation,
    goal_reached, initial_heading_deviation, make_global_plan)
from dddmr_navigation_tpu_torch.planning.global_.runtime import (
    GlobalPlannerRuntime)
from dddmr_navigation_tpu_torch.planning.global_.dwa import (
    DWAGlobalPlanManager)
from dddmr_navigation_tpu_torch.control.plan_manager import (
    AsyncPlanManager, SyncPlanManager)
from dddmr_navigation_tpu_torch.perception.layers import path_blocked
from dddmr_navigation_tpu_torch.control.fsm import (
    CmdSource, Decision, FSMInputs, fsm_step, init_fsm_state)
from dddmr_navigation_tpu_torch.control.recovery import (
    rotate_recovery_step, start_rotate_recovery)
from dddmr_navigation_tpu_torch.runtime import tracing

# the decisions in which plans are queried, and in which they are adopted
_QUERY = (Decision.D_PLANNING_WAITDONE, Decision.D_CONTROLLING,
          Decision.D_WAITING, Decision.D_ALIGN_HEADING,
          Decision.D_ALIGN_GOAL_HEADING)
_ADOPT = (Decision.D_PLANNING_WAITDONE, Decision.D_CONTROLLING,
          Decision.D_WAITING)


class MoveBaseDriver:
    """One robot's navigation over a loaded map. Each stage of the tick
    (plan manager, local tick, FSM) is a :func:`runtime.tracing.stage`
    mark: a span of the tracing recorder while it is on."""

    def __init__(self, cfg: NavigationConfig, ground: np.ndarray,
                 node_weight: Optional[np.ndarray] = None,
                 intensity: Optional[np.ndarray] = None,
                 threaded_plan_manager: bool = False,
                 runtime: Optional[GlobalPlannerRuntime] = None,
                 device="cuda"):
        self.cfg = cfg
        self.runtime = runtime or GlobalPlannerRuntime(
            cfg, ground, node_weight, intensity, device=device)
        self.device = self.runtime.device
        self.ground = self.runtime.ground
        self.graph = self.runtime.graph
        g = len(self.ground)
        self.dgraph = torch.full((g,), cfg.perception.max_obstacle_distance,
                                 device=self.device)
        self.lethal_pts = None
        self.lethal_valid = None

        dwa = DWAGlobalPlanManager(self.runtime, cfg.dwa_global_planner)
        manager_cls = (AsyncPlanManager if threaded_plan_manager
                       else SyncPlanManager)
        self.plan_manager = manager_cls(
            dwa, cfg.move_base.global_plan_query_frequency,
            action=cfg.move_base.global_planner_action_name)

        self.fsm = init_fsm_state(1, 0.0, self.device)
        self.decision = Decision.D_INITIAL     # the host copy of fsm.decision
        self.plan: Optional[GlobalPlan] = None
        self.goal = None
        self.recovery = None
        self.recovery_succeed = False
        self.last_cmd = None
        self.last_planner_state = None
        lp = cfg.local_planner
        empty = make_global_plan(np.zeros((1, 3, 3), np.float32),
                                 max_len=lp.max_plan_len, device=self.device)
        self._empty_plan = empty._replace(
            valid=torch.zeros_like(empty.valid),
            count=torch.zeros_like(empty.count))

    def close(self):
        """Shut down the plan manager's worker thread (no-op when sync)."""
        close = getattr(self.plan_manager, "close", None)
        if close is not None:
            close()

    def set_goal(self, goal_pos, now=0.0, goal_quat=None):
        self.goal = np.asarray(goal_pos, np.float32)
        if goal_quat is None:
            goal_quat = np.asarray([0.0, 0.0, 0.0, 1.0], np.float32)
        self.fsm = init_fsm_state(1, now, self.device)
        self.decision = Decision.D_INITIAL
        self.plan = None
        self.recovery = None
        self.plan_manager.set_goal(self.goal,
                                   np.asarray(goal_quat, np.float32))

    def set_dgraph(self, dgraph):
        self.dgraph = torch.as_tensor(dgraph, device=self.device)

    def set_lethal(self, lethal_pts, lethal_valid):
        """The aggregated lethal cloud for the planner's long-edge LOS check
        (`stacked_perception.cpp:142-155` → `a_star_on_pc.cpp:168-198`)."""
        self.lethal_pts = lethal_pts
        self.lethal_valid = lethal_valid

    def _gate_tick(self, code: int, now: float):
        """A host-gate PlannerState (zero velocity, stay): the reference's
        early returns at `local_planner.cpp:482-524` with
        `p2p_move_base.cpp:495-503`'s zero-velocity handling."""
        dev = self.device
        f = torch.zeros((1,), dtype=torch.bool, device=dev)
        code_t = torch.full((1,), code, dtype=torch.int32, device=dev)
        x = FSMInputs(
            now=torch.full((), now, device=dev),
            robot_pos=torch.zeros((1, 3), device=dev),
            robot_yaw=torch.zeros((1,), device=dev),
            has_new_plan=f, plan_empty=f, goal_reached=f,
            initial_heading_aligned=f, goal_heading_aligned=f,
            ps_simple=code_t, ps_rotate=code_t,
            recovery_active=torch.full((1,), self.recovery is not None,
                                       device=dev),
            recovery_succeed=torch.full((1,), self.recovery_succeed,
                                        device=dev))
        self.fsm, out = fsm_step(self.cfg.move_base, self.fsm, x)
        dec, done, ok = torch.stack([self.fsm.decision[0], out.done[0].int(),
                                     out.succeeded[0].int()]).tolist()
        self.decision = Decision(dec)
        return 0.0, 0.0, self.decision, bool(done), bool(ok)

    def tick(self, robot_pos, robot_quat, v, w, obstacles, obs_valid, now,
             sensor_ok: bool = True, tf_ok: bool = True,
             allowed_max_speed: float = -1.0):
        """One controller cycle. robot_pos (3,), robot_quat (4,) or (1, 4);
        obstacles (1, M, 3), obs_valid (1, M). ``sensor_ok``/``tf_ok`` are
        the host freshness gates; ``allowed_max_speed`` the speed-limit
        layer's cap (-1 = unlimited; a float or a (1,) tensor). Returns
        (vx, wz, decision, done, succeeded)."""
        lcfg = self.cfg.local_planner
        dev = self.device
        pos = torch.as_tensor(robot_pos, dtype=torch.float32,
                              device=dev).reshape(1, 3)
        quat = torch.as_tensor(robot_quat, dtype=torch.float32,
                               device=dev).reshape(1, 4)

        if not tf_ok:
            return self._gate_tick(int(PlannerState.TF_FAIL), now)
        if not sensor_ok:
            return self._gate_tick(int(PlannerState.PERCEPTION_MALFUNCTION),
                                   now)

        # the recovery sub-loop preempts everything
        if self.recovery is not None:
            tracing.stage("local tick")
            rec, wz, done, failed = rotate_recovery_step(
                lcfg, self.recovery, pos, quat, obstacles, obs_valid)
            wz, done, failed = torch.stack(
                [wz[0], done[0].float(), failed[0].float()]).tolist()
            if done or failed:
                self.recovery = None
                self.recovery_succeed = bool(done) and not bool(failed)
            else:
                self.recovery = rec
            return 0.0, wz, self.decision, False, False

        # the plan manager's queries run through every state once started
        # (`p2p_global_plan_manager.cpp:83-132`); plans are adopted only in
        # planning_waitdone, controlling and waiting
        # (`p2p_move_base.cpp:286-303,469-489`)
        tracing.stage("plan manager")
        has_new_plan = plan_empty = False
        if self.goal is not None and self.decision in _QUERY:
            self.plan_manager.offer(
                np.asarray(robot_pos, np.float32).reshape(3), self.dgraph,
                now, lethal_pts=self.lethal_pts,
                lethal_valid=self.lethal_valid)
        if self.goal is not None and self.decision in _ADOPT:
            result = self.plan_manager.take_plan()
            if result is not None:
                n = min(len(result.positions), lcfg.max_plan_len)
                self.plan = make_global_plan(
                    result.positions[None, :n], result.quats[None, :n],
                    max_len=lcfg.max_plan_len, device=dev)
                has_new_plan = True
            elif self.plan_manager.last_query_empty():
                has_new_plan, plan_empty = True, True

        tracing.stage("local tick")
        plan = self.plan if self.plan is not None else self._empty_plan
        hd, init_aligned, _ = initial_heading_deviation(lcfg, plan, pos, quat)
        ghd, goal_aligned = goal_heading_deviation(lcfg, plan, quat)
        reached = goal_reached(lcfg, plan, pos)

        v_t = torch.full((1,), float(v), device=dev)
        w_t = torch.full((1,), float(w), device=dev)
        cmd_simple = compute_velocity_command(
            lcfg, plan, pos, quat, v_t, w_t, obstacles, obs_valid,
            torch.as_tensor(allowed_max_speed, dtype=torch.float32,
                            device=dev).reshape(1),
            torch.zeros((1,), device=dev))
        # the rotate generator feeds only the align states
        in_goal_align = self.decision == Decision.D_ALIGN_GOAL_HEADING
        if in_goal_align or self.decision == Decision.D_ALIGN_HEADING:
            cmd_rotate = compute_velocity_command(
                lcfg, plan, pos, quat, v_t, w_t, obstacles, obs_valid,
                torch.full((1,), -1.0, device=dev),
                ghd if in_goal_align else hd,
                "differential_drive_rotate_shortest_angle")
            ps_rotate = cmd_rotate.state
        else:
            cmd_rotate = None
            ps_rotate = torch.full((1,), int(PlannerState.TRAJECTORY_FOUND),
                                   dtype=torch.int32, device=dev)

        # the path-blocked opinion overrides TRAJECTORY_FOUND
        # (`local_planner.cpp:597-608`)
        blocked = path_blocked(cmd_simple.prune, obstacles, obs_valid,
                               self.cfg.perception.path_blocked_check_radius)
        found = cmd_simple.state == int(PlannerState.TRAJECTORY_FOUND)
        ps_simple = torch.where(found & blocked,
                                int(PlannerState.PATH_BLOCKED_WAIT),
                                cmd_simple.state).int()
        self.last_cmd = cmd_simple

        tracing.stage("FSM")
        x = FSMInputs(
            now=torch.full((), now, device=dev),
            robot_pos=pos, robot_yaw=yaw_from_quat(quat),
            has_new_plan=torch.full((1,), has_new_plan, device=dev),
            plan_empty=torch.full((1,), plan_empty, device=dev),
            goal_reached=reached, initial_heading_aligned=init_aligned,
            goal_heading_aligned=goal_aligned, ps_simple=ps_simple,
            ps_rotate=ps_rotate,
            recovery_active=torch.full((1,), self.recovery is not None,
                                       device=dev),
            recovery_succeed=torch.full((1,), self.recovery_succeed,
                                        device=dev))
        self.fsm, out = fsm_step(self.cfg.move_base, self.fsm, x)
        rot = cmd_rotate if cmd_rotate is not None else cmd_simple
        (dec, src, done, ok, rec_req, ps, vs, ws, vr, wr) = torch.stack([
            self.fsm.decision[0].float(), out.cmd_source[0].float(),
            out.done[0].float(), out.succeeded[0].float(),
            out.request_recovery[0].float(), ps_simple[0].float(),
            cmd_simple.vx[0], cmd_simple.wz[0], rot.vx[0], rot.wz[0]]).tolist()
        self.decision = Decision(int(dec))
        self.last_planner_state = int(ps)

        if rec_req:
            self.recovery = start_rotate_recovery(quat)
            self.recovery_succeed = False
        src = int(src)
        if src == CmdSource.SIMPLE:
            vx, wz = vs, ws
        elif src == CmdSource.ROTATE and cmd_rotate is not None:
            vx, wz = vr, wr
        else:
            vx, wz = 0.0, 0.0
        if done:
            # finished or aborted: stop the queries and the DWA recompute
            self.plan_manager.stop()
        return vx, wz, self.decision, bool(done), bool(ok)
