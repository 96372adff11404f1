"""The p2p move-base decision FSM, one step of a whole fleet.

Counterpart of ``dddmr_navigation_tpu/control/fsm.py``
(`P2PMoveBase::executeCycle` + `P2P_FSM`, `p2p_move_base.cpp:265-658`,
`p2p_fsm.cpp:41-113`): integer decision states, time as an explicit f32
input, and every transition a tensor select over the robot axis B, so a
step never reads a tensor value on the host. Per-tick inputs are the
predicates the reference computes in place; outputs are the command
selector and the host-facing requests.
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from navbench.reference.config import MoveBaseConfig
from navbench.reference.geometry import normalize_angle
from navbench.reference.planning.local.planner import PlannerState
from navbench.reference.rounding import fma_norm


class Decision(enum.IntEnum):
    D_INITIAL = 0
    D_PLANNING = 1
    D_PLANNING_WAITDONE = 2
    D_ALIGN_HEADING = 3
    D_CONTROLLING = 4
    D_ALIGN_GOAL_HEADING = 5
    D_WAITING = 6
    D_RECOVERY_WAITDONE = 7
    D_SUCCEED = 8
    D_ABORT = 9


class CmdSource(enum.IntEnum):
    ZERO = 0       # publish zero velocity
    SIMPLE = 1     # differential_drive_simple command
    ROTATE = 2     # differential_drive_rotate_shortest_angle command


class FSMState(NamedTuple):
    decision: torch.Tensor                # (B,) int32
    last_valid_plan: torch.Tensor         # (B,) f32 seconds
    last_valid_control: torch.Tensor      # (B,) f32
    last_oscillation_reset: torch.Tensor  # (B,) f32
    oscillation_pos: torch.Tensor         # (B, 3)
    oscillation_yaw: torch.Tensor         # (B,)
    waiting_time: torch.Tensor            # (B,)
    no_plan_recovery_count: torch.Tensor  # (B,) int32


class FSMInputs(NamedTuple):
    now: torch.Tensor                     # () f32 seconds
    robot_pos: torch.Tensor               # (B, 3)
    robot_yaw: torch.Tensor               # (B,)
    has_new_plan: torch.Tensor            # (B,) bool, a plan arrived
    plan_empty: torch.Tensor              # (B,) bool, and it is empty
    goal_reached: torch.Tensor            # (B,) bool
    initial_heading_aligned: torch.Tensor  # (B,) bool
    goal_heading_aligned: torch.Tensor    # (B,) bool
    ps_simple: torch.Tensor               # (B,) PlannerState of simple gen
    ps_rotate: torch.Tensor               # (B,) PlannerState of rotate gen
    recovery_active: torch.Tensor         # (B,) bool
    recovery_succeed: torch.Tensor        # (B,) bool, last recovery result


class FSMOutputs(NamedTuple):
    cmd_source: torch.Tensor              # (B,) int32 CmdSource
    request_plan_query: torch.Tensor      # (B,) bool
    request_recovery: torch.Tensor        # (B,) bool
    done: torch.Tensor                    # (B,) bool, terminal
    succeeded: torch.Tensor               # (B,) bool


def init_fsm_state(b: int, now=0.0, device="cuda") -> FSMState:
    """``b`` robots in d_initial, every clock at ``now``."""
    t = torch.full((b,), now, dtype=torch.float32, device=device)
    return FSMState(
        decision=torch.full((b,), int(Decision.D_INITIAL), dtype=torch.int32,
                            device=device),
        last_valid_plan=t, last_valid_control=t.clone(),
        last_oscillation_reset=t.clone(),
        oscillation_pos=torch.zeros((b, 3), device=device),
        oscillation_yaw=torch.zeros((b,), device=device),
        waiting_time=t.clone(),
        no_plan_recovery_count=torch.zeros((b,), dtype=torch.int32,
                                           device=device))


def fsm_step(cfg: MoveBaseConfig, s: FSMState, x: FSMInputs
             ) -> tuple[FSMState, FSMOutputs]:
    """One executeCycle of every robot: a pure function of (state,
    inputs). The patience tests compare f32 differences of f32 times, as
    the JAX package's do."""
    P, D = PlannerState, Decision
    dev = s.decision.device
    now = torch.as_tensor(x.now, dtype=torch.float32, device=dev)

    def sel(cond, a, b):
        return torch.where(cond, a, b)

    # --- oscillation reset (`p2p_move_base.cpp:267-273`) ---
    dist = fma_norm(x.robot_pos - s.oscillation_pos)
    dyaw = torch.abs(normalize_angle(x.robot_yaw - s.oscillation_yaw))
    osc_reset = ((dist >= cfg.oscillation_distance)
                 | (dyaw >= cfg.oscillation_angle))
    osc_pos = sel(osc_reset[:, None], x.robot_pos, s.oscillation_pos)
    osc_yaw = sel(osc_reset, x.robot_yaw, s.oscillation_yaw)
    last_osc = sel(osc_reset, now, s.last_oscillation_reset)

    osc_timeout = ((now - last_osc >= cfg.oscillation_patience)
                   & (cfg.oscillation_patience > 0))
    ctrl_timeout = now - s.last_valid_control > cfg.controller_patience
    plan_timeout = now - s.last_valid_plan > cfg.planner_patience

    d = s.decision
    nxt = d
    cmd = torch.full_like(d, int(CmdSource.ZERO))
    false = torch.zeros_like(d, dtype=torch.bool)
    req_plan, req_recovery, done, succeeded = false, false, false, false
    lvp, lvc, wt = s.last_valid_plan, s.last_valid_control, s.waiting_time
    rec_cnt = s.no_plan_recovery_count

    # --- d_initial, d_planning ---
    nxt = sel(d == D.D_INITIAL, int(D.D_PLANNING), nxt)
    in_plan = d == D.D_PLANNING
    req_plan = req_plan | in_plan
    nxt = sel(in_plan, int(D.D_PLANNING_WAITDONE), nxt)

    # --- d_planning_waitdone ---
    in_wait = d == D.D_PLANNING_WAITDONE
    got_plan = in_wait & x.has_new_plan & ~x.plan_empty
    empty_plan = in_wait & x.has_new_plan & x.plan_empty
    nxt = sel(got_plan, int(D.D_ALIGN_HEADING), nxt)
    lvp = sel(got_plan, now, lvp)
    nxt = sel(empty_plan, int(D.D_PLANNING), nxt)
    to_recovery_pt = in_wait & plan_timeout
    nxt = sel(to_recovery_pt, int(D.D_RECOVERY_WAITDONE), nxt)
    req_recovery = req_recovery | to_recovery_pt

    # --- the align states (`p2p_move_base.cpp:316-389,392-459`) ---
    def align_branch(in_state, aligned, next_on_aligned, stay_state,
                     nxt, cmd, req_recovery, lvp, lvc,
                     all_fail_goes_planning: bool):
        ps = x.ps_rotate
        nxt = sel(in_state & aligned, next_on_aligned, nxt)
        active = in_state & ~aligned
        to_rec = active & osc_timeout
        nxt = sel(to_rec, int(D.D_RECOVERY_WAITDONE), nxt)
        req_recovery = req_recovery | to_rec
        act = active & ~osc_timeout

        found = act & (ps == P.TRAJECTORY_FOUND)
        cmd = sel(found, int(CmdSource.ROTATE), cmd)
        lvc = sel(found, now, lvc)
        nxt = sel(found, stay_state, nxt)

        prune_fail = act & (ps == P.PRUNE_PLAN_FAIL)
        nxt = sel(prune_fail, int(D.D_PLANNING), nxt)
        lvp = sel(prune_fail, now, lvp)

        blocked = (ps == P.PATH_BLOCKED_WAIT) | (ps == P.PATH_BLOCKED_REPLANNING)
        all_fail = ps == P.ALL_TRAJECTORIES_FAIL
        fail_mask = act & (all_fail if all_fail_goes_planning
                           else all_fail | blocked)
        fail_to_rec = fail_mask & ctrl_timeout
        nxt = sel(fail_to_rec, int(D.D_RECOVERY_WAITDONE), nxt)
        req_recovery = req_recovery | fail_to_rec
        fail_to_plan = fail_mask & ~ctrl_timeout
        if all_fail_goes_planning:
            nxt = sel(fail_to_plan, int(D.D_PLANNING), nxt)
            lvp = sel(fail_to_plan, now, lvp)
            nxt = sel(act & blocked, int(D.D_PLANNING), nxt)
            lvp = sel(act & blocked, now, lvp)
        else:
            nxt = sel(fail_to_plan, stay_state, nxt)
        return nxt, cmd, req_recovery, lvp, lvc

    nxt, cmd, req_recovery, lvp, lvc = align_branch(
        d == D.D_ALIGN_HEADING, x.initial_heading_aligned,
        int(D.D_CONTROLLING), int(D.D_ALIGN_HEADING),
        nxt, cmd, req_recovery, lvp, lvc, all_fail_goes_planning=True)

    # --- d_align_goal_heading ---
    in_galign = d == D.D_ALIGN_GOAL_HEADING
    goal_done = in_galign & x.goal_heading_aligned
    done = done | goal_done
    succeeded = succeeded | goal_done
    nxt = sel(goal_done, int(D.D_SUCCEED), nxt)
    nxt, cmd, req_recovery, lvp, lvc = align_branch(
        in_galign, x.goal_heading_aligned, int(D.D_SUCCEED),
        int(D.D_ALIGN_GOAL_HEADING),
        nxt, cmd, req_recovery, lvp, lvc, all_fail_goes_planning=False)

    # --- d_controlling (`p2p_move_base.cpp:459-549`) ---
    in_ctrl = d == D.D_CONTROLLING
    reach = in_ctrl & x.goal_reached
    nxt = sel(reach, int(D.D_ALIGN_GOAL_HEADING), nxt)
    ctl = in_ctrl & ~reach
    to_rec_osc = ctl & osc_timeout
    nxt = sel(to_rec_osc, int(D.D_RECOVERY_WAITDONE), nxt)
    req_recovery = req_recovery | to_rec_osc
    act = ctl & ~osc_timeout

    ps = x.ps_simple
    found = act & (ps == P.TRAJECTORY_FOUND)
    cmd = sel(found, int(CmdSource.SIMPLE), cmd)
    lvc = sel(found, now, lvc)
    prune_fail = act & (ps == P.PRUNE_PLAN_FAIL)
    nxt = sel(prune_fail, int(D.D_PLANNING), nxt)
    lvp = sel(prune_fail, now, lvp)
    all_fail = act & (ps == P.ALL_TRAJECTORIES_FAIL)
    af_rec = all_fail & ctrl_timeout
    nxt = sel(af_rec, int(D.D_RECOVERY_WAITDONE), nxt)
    req_recovery = req_recovery | af_rec
    af_plan = all_fail & ~ctrl_timeout
    nxt = sel(af_plan, int(D.D_PLANNING), nxt)
    lvp = sel(af_plan, now, lvp)
    blocked_replan = act & (ps == P.PATH_BLOCKED_REPLANNING)
    nxt = sel(blocked_replan, int(D.D_PLANNING), nxt)
    lvp = sel(blocked_replan, now, lvp)
    blocked_wait = act & (ps == P.PATH_BLOCKED_WAIT)
    nxt = sel(blocked_wait, int(D.D_WAITING), nxt)
    wt = sel(blocked_wait, now, wt)

    # --- d_recovery_waitdone (`p2p_move_base.cpp:551-583`) ---
    in_rec = (d == D.D_RECOVERY_WAITDONE) & ~x.recovery_active
    over_retry = in_rec & (rec_cnt >= cfg.no_plan_retry_num)
    nxt = sel(over_retry, int(D.D_ABORT), nxt)
    done = done | over_retry
    rec_ok = in_rec & ~over_retry & x.recovery_succeed
    nxt = sel(rec_ok, int(D.D_PLANNING), nxt)
    rec_cnt = sel(rec_ok, rec_cnt + 1, rec_cnt)
    lvp = sel(rec_ok, now, lvp)
    rec_fail = in_rec & ~over_retry & ~x.recovery_succeed
    nxt = sel(rec_fail, int(D.D_ABORT), nxt)
    done = done | rec_fail

    # --- d_waiting (`p2p_move_base.cpp:585-655`) ---
    in_waiting = d == D.D_WAITING
    wait_over = in_waiting & (now - wt >= cfg.waiting_patience)
    nxt = sel(wait_over, int(D.D_PLANNING), nxt)
    lvp = sel(wait_over, now, lvp)
    w_act = in_waiting & ~wait_over
    w_found = w_act & (ps == P.TRAJECTORY_FOUND)
    nxt = sel(w_found, int(D.D_CONTROLLING), nxt)
    lvc = sel(w_found, now, lvc)
    w_prune = w_act & (ps == P.PRUNE_PLAN_FAIL)
    nxt = sel(w_prune, int(D.D_PLANNING), nxt)
    lvp = sel(w_prune, now, lvp)
    w_fail = w_act & (ps == P.ALL_TRAJECTORIES_FAIL)
    wf_rec = w_fail & ctrl_timeout
    nxt = sel(wf_rec, int(D.D_RECOVERY_WAITDONE), nxt)
    req_recovery = req_recovery | wf_rec
    wf_plan = w_fail & ~ctrl_timeout
    nxt = sel(wf_plan, int(D.D_PLANNING), nxt)
    lvp = sel(wf_plan, now, lvp)
    # PATH_BLOCKED_* while waiting: stay

    # terminal states absorb
    terminal = (d == D.D_SUCCEED) | (d == D.D_ABORT)
    nxt = sel(terminal, d, nxt)
    done = done | terminal
    succeeded = succeeded | (d == D.D_SUCCEED)

    s2 = FSMState(
        decision=nxt, last_valid_plan=lvp, last_valid_control=lvc,
        last_oscillation_reset=last_osc, oscillation_pos=osc_pos,
        oscillation_yaw=osc_yaw, waiting_time=wt,
        no_plan_recovery_count=rec_cnt)
    out = FSMOutputs(cmd_source=cmd, request_plan_query=req_plan,
                     request_recovery=req_recovery, done=done,
                     succeeded=succeeded)
    return s2, out
