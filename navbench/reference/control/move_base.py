"""The p2p move-base driver: goal → plan → control loop → cmd_vel, for one
robot (counterpart of ``dddmr_navigation_tpu/control/move_base.py``, the
reference's `P2PMoveBase` and `P2PGlobalPlanManager`,
`p2p_move_base.cpp`, `p2p_global_plan_manager.cpp`).

Host sequencing around the device functions, with B = 1 inside: global
plan queries through a :class:`SyncPlanManager` (DWA windowed replans
included), the local
planner with the generator the FSM selects, the path-blocked override, the
FSM step, the rotate recovery, and the host failure gates (sensor
freshness ⇒ PERCEPTION_MALFUNCTION, TF age ⇒ TF_FAIL,
`local_planner.cpp:482-524`).

The tick reads the device once, after the FSM: decision, command source,
done, succeeded and the recovery request, with both commands.
:meth:`MoveBaseDriver.drive` returns the tick's answer as a
:class:`DriveOut` (the command also as a device tensor);
:meth:`MoveBaseDriver.tick` returns it as host values. What the driver
carries from tick to tick is a :class:`DriverState` (:meth:`state`,
:meth:`load`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from navbench.reference.config import NavigationConfig
from navbench.reference.geometry import yaw_from_quat
from navbench.reference.planning.local.planner import (
    GlobalPlan, PlannerState, VelocityCommand, compute_velocity_command,
    goal_heading_deviation, goal_reached, initial_heading_deviation,
    make_global_plan)
from navbench.reference.planning.global_.runtime import (
    GlobalPlannerRuntime)
from navbench.reference.planning.global_.dwa import (
    DWAGlobalPlanManager, to_arrays, to_tensors)
from navbench.reference.control.plan_manager import (
    PlanManagerState, SyncPlanManager)
from navbench.reference.perception.layers import path_blocked
from navbench.reference.control.fsm import (
    CmdSource, Decision, FSMInputs, FSMState, fsm_step, init_fsm_state)
from navbench.reference.control.recovery import (
    RotateRecoveryState, rotate_recovery_step, start_rotate_recovery)

# the decisions in which plans are queried, and in which they are adopted
_QUERY = (Decision.D_PLANNING_WAITDONE, Decision.D_CONTROLLING,
          Decision.D_WAITING, Decision.D_ALIGN_HEADING,
          Decision.D_ALIGN_GOAL_HEADING)
_ADOPT = (Decision.D_PLANNING_WAITDONE, Decision.D_CONTROLLING,
          Decision.D_WAITING)


class DriveOut(NamedTuple):
    """One tick's answer."""
    cmd: torch.Tensor          # (1, 2) [vx, wz] on the device
    vx: float                  # the same command, read to the host with
    wz: float                  # the decision
    decision: Decision
    source: int                # CmdSource; -1 for a recovery step's turn
    done: bool
    succeeded: bool
    diag: dict                 # {name: tensor or None}, see drive()


class DriverState(NamedTuple):
    """What a :class:`MoveBaseDriver` carries from tick to tick."""
    fsm: FSMState
    decision: int                        # the host copy of fsm.decision
    dgraph: torch.Tensor                 # (G,) the field the planner reads
    lethal_pts: Optional[torch.Tensor]   # (L, 3) the LOS gate's cloud
    lethal_valid: Optional[torch.Tensor]  # (L,)
    goal: Optional[torch.Tensor]         # (3,) CPU, None before a goal
    plan: Optional[GlobalPlan]           # the adopted plan (B = 1)
    recovery: Optional[RotateRecoveryState]
    recovery_succeed: bool
    plan_manager: PlanManagerState


class _Local(NamedTuple):
    """The local tick's products that the FSM reads."""
    simple: VelocityCommand
    rotate: Optional[VelocityCommand]    # only in the align states
    ps_simple: torch.Tensor              # (1,) after the path-blocked check
    ps_rotate: torch.Tensor
    reached: torch.Tensor
    initial_aligned: torch.Tensor
    goal_aligned: torch.Tensor


class MoveBaseDriver:
    """One robot's navigation over a loaded map; the stages of a tick are
    the plan manager :meth:`_plan`, the local tick :meth:`_local` and the
    FSM :meth:`_decide`."""

    def __init__(self, cfg: NavigationConfig, ground: np.ndarray,
                 node_weight: Optional[np.ndarray] = None,
                 intensity: Optional[np.ndarray] = None,
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
        self._no_iters = torch.zeros((), dtype=torch.int32,
                                     device=self.device)

        dwa = DWAGlobalPlanManager(self.runtime, cfg.dwa_global_planner)
        self.plan_manager = SyncPlanManager(
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

    def state(self) -> DriverState:
        return DriverState(
            fsm=self.fsm, decision=int(self.decision), dgraph=self.dgraph,
            lethal_pts=self.lethal_pts, lethal_valid=self.lethal_valid,
            goal=to_tensors(self.goal), plan=self.plan,
            recovery=self.recovery, recovery_succeed=self.recovery_succeed,
            plan_manager=self.plan_manager.state())

    def load(self, s: DriverState):
        """Put back a :meth:`state`. Nothing of it is written in place."""
        self.fsm, self.decision = s.fsm, Decision(s.decision)
        self.dgraph = s.dgraph
        self.lethal_pts, self.lethal_valid = s.lethal_pts, s.lethal_valid
        self.goal = to_arrays(s.goal)
        self.plan, self.recovery = s.plan, s.recovery
        self.recovery_succeed = s.recovery_succeed
        self.plan_manager.load(s.plan_manager)

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

    def _diag(self, local: Optional[_Local] = None, queries: int = 0,
              adopted: int = 0, recomputes: int = 0,
              relax_iters: Optional[torch.Tensor] = None) -> dict:
        simple = local.simple if local is not None else None
        return {
            "planner_state": None if local is None else local.ps_simple,
            "best_index": None if simple is None else simple.best_index,
            "best_cost": None if simple is None else simple.best_cost,
            "costs": None if simple is None else simple.costs,
            "plan_queries": torch.tensor(queries),
            "plan_adopted": torch.tensor(adopted),
            "dwa_recomputes": torch.tensor(recomputes),
            "relax_iters": (self._no_iters if relax_iters is None
                            else relax_iters)}

    def _gate_tick(self, code: int, now: float) -> DriveOut:
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
        dec, src, done, ok = torch.stack([
            self.fsm.decision[0], out.cmd_source[0], out.done[0].int(),
            out.succeeded[0].int()]).tolist()
        self.decision = Decision(dec)
        return DriveOut(torch.zeros((1, 2), device=dev), 0.0, 0.0,
                        self.decision, int(src), bool(done), bool(ok),
                        self._diag())

    def tick(self, robot_pos, robot_quat, v, w, obstacles, obs_valid, now,
             sensor_ok: bool = True, tf_ok: bool = True,
             allowed_max_speed: float = -1.0):
        """:meth:`drive` as host values: (vx, wz, decision, done,
        succeeded)."""
        out = self.drive(robot_pos, robot_quat, v, w, obstacles, obs_valid,
                         now, sensor_ok=sensor_ok, tf_ok=tf_ok,
                         allowed_max_speed=allowed_max_speed)
        return out.vx, out.wz, out.decision, out.done, out.succeeded

    def drive(self, robot_pos, robot_quat, v, w, obstacles, obs_valid, now,
              sensor_ok: bool = True, tf_ok: bool = True,
              allowed_max_speed: float = -1.0) -> DriveOut:
        """One controller cycle. robot_pos (3,), robot_quat (4,) or (1, 4);
        obstacles (1, M, 3), obs_valid (1, M). ``sensor_ok``/``tf_ok`` are
        the host freshness gates; ``allowed_max_speed`` the speed-limit
        layer's cap (-1 = unlimited; a float or a (1,) tensor). The diag
        holds the simple generator's planner state (after the path-blocked
        check), chosen sample, its cost and every sample's cost (None on a
        gate or recovery tick), and this tick's plan queries, plans
        adopted and DWA recomputes (CPU counts) and the iterations its
        relaxations ran (a device scalar)."""
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
            return self._recover(pos, quat, obstacles, obs_valid)

        planned = self._plan(robot_pos, now)
        local = self._local(pos, quat, v, w, obstacles, obs_valid,
                            allowed_max_speed)
        return self._decide(pos, quat, now, local, *planned)

    def _recover(self, pos, quat, obstacles, obs_valid) -> DriveOut:
        """One step of the rotate recovery: (0, its turn)."""
        rec, wz, done, failed = rotate_recovery_step(
            self.cfg.local_planner, self.recovery, pos, quat, obstacles,
            obs_valid)
        cmd = torch.stack([torch.zeros_like(wz), wz], dim=1)
        wz, done, failed = torch.stack(
            [wz[0], done[0].float(), failed[0].float()]).tolist()
        if done or failed:
            self.recovery = None
            self.recovery_succeed = bool(done) and not bool(failed)
        else:
            self.recovery = rec
        return DriveOut(cmd, 0.0, wz, self.decision, -1, False, False,
                        self._diag())

    def _plan(self, robot_pos, now) -> tuple:
        """The plan manager's queries run through every state once started
        (`p2p_global_plan_manager.cpp:83-132`); plans are adopted only in
        planning_waitdone, controlling and waiting
        (`p2p_move_base.cpp:286-303,469-489`). Returns (has_new_plan,
        plan_empty, queries, adopted, recomputes, the relaxations'
        iterations or None) of this tick."""
        lcfg = self.cfg.local_planner
        pm = self.plan_manager
        self.runtime.relax_iters = None
        last_query, last_recompute = pm._last_query_t, pm.dwa.last_recompute_t
        has_new_plan = plan_empty = False
        if self.goal is not None and self.decision in _QUERY:
            pm.offer(np.asarray(robot_pos, np.float32).reshape(3),
                     self.dgraph, now, lethal_pts=self.lethal_pts,
                     lethal_valid=self.lethal_valid)
        if self.goal is not None and self.decision in _ADOPT:
            result = pm.take_plan()
            if result is not None:
                n = min(len(result.positions), lcfg.max_plan_len)
                self.plan = make_global_plan(
                    result.positions[None, :n], result.quats[None, :n],
                    max_len=lcfg.max_plan_len, device=self.device)
                has_new_plan = True
            elif pm.last_query_empty():
                has_new_plan, plan_empty = True, True
        return (has_new_plan, plan_empty,
                int(pm._last_query_t != last_query),
                int(has_new_plan and not plan_empty),
                int(pm.dwa.last_recompute_t != last_recompute),
                self.runtime.relax_iters)

    def _local(self, pos, quat, v, w, obstacles, obs_valid,
               allowed_max_speed) -> _Local:
        """Both generators (the rotate one only in the align states) and
        the path-blocked opinion, which overrides TRAJECTORY_FOUND
        (`local_planner.cpp:597-608`)."""
        lcfg = self.cfg.local_planner
        dev = self.device
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

        blocked = path_blocked(cmd_simple.prune, obstacles, obs_valid,
                               self.cfg.perception.path_blocked_check_radius)
        found = cmd_simple.state == int(PlannerState.TRAJECTORY_FOUND)
        ps_simple = torch.where(found & blocked,
                                int(PlannerState.PATH_BLOCKED_WAIT),
                                cmd_simple.state).int()
        self.last_cmd = cmd_simple
        return _Local(cmd_simple, cmd_rotate, ps_simple, ps_rotate, reached,
                      init_aligned, goal_aligned)

    def _decide(self, pos, quat, now, local: _Local, has_new_plan: bool,
                plan_empty: bool, queries: int, adopted: int,
                recomputes: int, relax_iters) -> DriveOut:
        """The FSM step and the tick's one device read; the command its
        source selects."""
        dev = self.device
        x = FSMInputs(
            now=torch.full((), now, device=dev),
            robot_pos=pos, robot_yaw=yaw_from_quat(quat),
            has_new_plan=torch.full((1,), has_new_plan, device=dev),
            plan_empty=torch.full((1,), plan_empty, device=dev),
            goal_reached=local.reached,
            initial_heading_aligned=local.initial_aligned,
            goal_heading_aligned=local.goal_aligned,
            ps_simple=local.ps_simple, ps_rotate=local.ps_rotate,
            recovery_active=torch.full((1,), self.recovery is not None,
                                       device=dev),
            recovery_succeed=torch.full((1,), self.recovery_succeed,
                                        device=dev))
        self.fsm, out = fsm_step(self.cfg.move_base, self.fsm, x)
        simple = local.simple
        rot = local.rotate if local.rotate is not None else simple
        (dec, src, done, ok, rec_req, ps, vs, ws, vr, wr) = torch.stack([
            self.fsm.decision[0].float(), out.cmd_source[0].float(),
            out.done[0].float(), out.succeeded[0].float(),
            out.request_recovery[0].float(), local.ps_simple[0].float(),
            simple.vx[0], simple.wz[0], rot.vx[0], rot.wz[0]]).tolist()
        self.decision = Decision(int(dec))
        self.last_planner_state = int(ps)

        if rec_req:
            self.recovery = start_rotate_recovery(quat)
            self.recovery_succeed = False
        src = int(src)
        if src == CmdSource.SIMPLE:
            vx, wz, cmd = vs, ws, torch.stack([simple.vx, simple.wz], dim=1)
        elif src == CmdSource.ROTATE and local.rotate is not None:
            vx, wz, cmd = vr, wr, torch.stack([rot.vx, rot.wz], dim=1)
        else:
            vx, wz, cmd = 0.0, 0.0, torch.zeros((1, 2), device=dev)
        if done:
            # finished or aborted: stop the queries and the DWA recompute
            self.plan_manager.stop()
        return DriveOut(cmd, vx, wz, self.decision, src, bool(done), bool(ok),
                        self._diag(local, queries, adopted, recomputes,
                                   relax_iters))
