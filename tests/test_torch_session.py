"""The port's single-robot session vertical against the JAX package, on
the CPU: ``path_to_poses``, ``GlobalPlannerRuntime``, ``dwa_pivot`` and the
DWA manager, the plan managers, the move-base driver's gates, a
``NavigationSession`` chain with depth cameras and both zone layers, and
``interop.port_session_state``.

Each case feeds the same numpy inputs to the JAX function, called as its
call site calls it (jitted or eager), and to the port on ``"cpu"``. Exact
equality for node ids, counts, indices, decisions and state codes; plan
positions exact (ground coordinates and their f32 interpolation); 1e-6 for
orientations (``slope_aware_quat``'s atan2, sin and cos in PyTorch's and
XLA's CPU code); 1e-5 for commands and distance fields, the tolerance of
the earlier fused and fleet slices (a best index may be a tie).

Sizes: ``flat_ground_map(6, 4, 0.2)`` (651 nodes); a 32×32×16 window, a
16×180 range image, 3×5 samples of 32 steps, 2 cameras × 3 frames × 128
points for the session.
"""
import dataclasses
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddmr_navigation_tpu.config import NavigationConfig as JConfig
from dddmr_navigation_tpu.control.fsm import Decision as JDecision
from dddmr_navigation_tpu.control.move_base import MoveBaseDriver as JDriver
from dddmr_navigation_tpu.control.plan_manager import (
    SyncPlanManager as JSync)
from dddmr_navigation_tpu.planning.global_ import dwa as jdwa
from dddmr_navigation_tpu.planning.global_.planner import (
    path_to_poses as j_path_to_poses)
from dddmr_navigation_tpu.planning.global_.runtime import (
    GlobalPlannerRuntime as JRuntime)

from dddmr_navigation_tpu_torch import entry
from dddmr_navigation_tpu_torch.config import NavigationConfig
from dddmr_navigation_tpu_torch.control.fsm import Decision
from dddmr_navigation_tpu_torch.control.move_base import MoveBaseDriver
from dddmr_navigation_tpu_torch.control.plan_manager import (
    AsyncPlanManager, SyncPlanManager)
from dddmr_navigation_tpu_torch.interop import (
    port_session_state, session_fields, to_port)
from dddmr_navigation_tpu_torch.io import flat_ground_map
from dddmr_navigation_tpu_torch.planning.global_ import dwa as tdwa
from dddmr_navigation_tpu_torch.planning.global_.planner import (
    GlobalPathResult, path_to_poses)
from dddmr_navigation_tpu_torch.planning.global_.runtime import (
    GlobalPlannerRuntime)
from tools.make_session_golden import jax_config, jax_session

torch.set_num_threads(1)

CFG = NavigationConfig()
JCFG = JConfig()
IDQ = np.array([0, 0, 0, 1], np.float32)
FREE = 9999.0


@pytest.fixture(scope="module")
def runtimes():
    ground = flat_ground_map(6, 4, 0.2)
    return ground, GlobalPlannerRuntime(CFG, ground, device="cpu"), \
        JRuntime(JCFG, ground)


def obstacle_field(ground, center, radius=1.5):
    d = np.linalg.norm(ground[:, :2] - np.asarray(center, np.float32)[:2],
                       axis=1).astype(np.float32)
    return np.where(d < radius, d, FREE).astype(np.float32)


QUERIES = [((-2.8, -1.8, 0.0), (2.8, 1.8, 0.0), None),
           ((-2.5, 0.0, 0.0), (2.5, 0.2, 0.0), (0.0, 0.0)),
           ((2.6, 1.6, 0.0), (-2.0, -1.4, 0.0), (0.4, 0.6))]


def batched(jres):
    """A JAX GlobalPathResult as the port's, with B = 1."""
    return to_port(jax.tree_util.tree_map(
        lambda x: np.asarray(x)[None], jres), GlobalPathResult, "cpu")


@pytest.mark.parametrize("q", range(len(QUERIES)))
def test_runtime_plan_and_path_to_poses_match_jax(runtimes, q):
    """``GlobalPlannerRuntime.plan_result`` (snap, the turning relaxation,
    extraction, with the lethal cloud's LOS gate) equals the JAX runtime's
    jitted program, and ``path_to_poses`` of the same node path equals the
    JAX package's host function."""
    ground, rt, jrt = runtimes
    start, goal, obst = QUERIES[q]
    dg = (np.full(len(ground), FREE, np.float32) if obst is None
          else obstacle_field(ground, obst))
    lethal_pts = np.full((16, 3), 1e6, np.float32)
    lethal_valid = np.zeros(16, bool)
    n = min(16, int((dg < 0.5).sum()))
    lethal_pts[:n] = ground[dg < 0.5][:n]
    lethal_valid[:n] = True
    jres = jrt.plan_result(np.float32(start), np.float32(goal), dg,
                           lethal_pts, lethal_valid)
    res = rt.plan_result(np.float32(start), np.float32(goal), dg,
                         lethal_pts, lethal_valid)
    for f in ("node_ids", "node_valid", "length", "ok", "goal_idx", "iters"):
        np.testing.assert_array_equal(getattr(res, f)[0].numpy(),
                                      np.asarray(getattr(jres, f)), f)
    assert bool(res.ok[0]) and int(res.length[0]) > 10
    pos, quat = path_to_poses(CFG.global_planner, ground, batched(jres))
    jpos, jquat = j_path_to_poses(JCFG.global_planner, ground, jres)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_allclose(quat, jquat, atol=1e-6, rtol=0)
    got = rt.plan(np.float32(start), np.float32(goal), dg, lethal_pts,
                  lethal_valid)
    want = jrt.plan(np.float32(start), np.float32(goal), dg, lethal_pts,
                    lethal_valid)
    np.testing.assert_array_equal(got[0], want[0])
    if obst is not None:   # the plan keeps out of the lethal disk
        assert (np.linalg.norm(got[0][:, :2] - obst, axis=1) > 0.4).all()


def test_path_to_poses_empty_and_single_node(runtimes):
    ground, rt, jrt = runtimes
    jres = jrt.plan_result(np.float32([0, 0, 0]), np.float32([0, 0, 0]),
                           np.full(len(ground), FREE, np.float32))
    pos, quat = path_to_poses(CFG.global_planner, ground, batched(jres))
    jpos, jquat = j_path_to_poses(JCFG.global_planner, ground, jres)
    np.testing.assert_array_equal(pos, jpos)
    assert pos.shape == (1, 3) and quat.shape == (1, 4)
    res = batched(jres)._replace(node_valid=torch.zeros(1, 512, dtype=bool))
    pos, quat = path_to_poses(CFG.global_planner, ground, res)
    assert pos.shape == (0, 3) and quat.shape == (0, 4)


# ---------------------------------------------------------------------------
# DWA
# ---------------------------------------------------------------------------

def test_dwa_pivot_matches_jitted_jax_with_blocked_shifts():
    """The pivot walk of `test_dwa_planner.py::test_dwa_pivot_shifts_past_
    blocked_goal` for two robots at once: one unblocked, one whose
    tentative goal (and the next shifts) sit in a lethal disk; and plans
    with a gap (no ground under the poses)."""
    ground = flat_ground_map(16, 4, 0.2)
    g = len(ground)
    xs = np.arange(-7.0, 7.0, 0.1, dtype=np.float32)
    plan = np.stack([xs, np.zeros_like(xs), np.zeros_like(xs)], 1)
    pad = np.zeros((2, 256, 3), np.float32)
    pad[:, :len(plan)] = plan
    pad[1, 100:140, 1] = 3.0                 # poses off the ground
    valid = np.zeros((2, 256), bool)
    valid[:, :len(plan)] = True
    robots = np.array([[-7.0, 0.0, 0.0], [-6.0, 0.1, 0.0]], np.float32)
    dg = np.stack([np.full(g, FREE, np.float32),
                   obstacle_field(ground, (-3.9, 0.0), 1.5)])
    fn = jax.jit(lambda *a: jdwa.dwa_pivot(
        *a, look_ahead_distance=2.0, inscribed_radius=0.5))
    pivot, i0 = tdwa.dwa_pivot(
        torch.tensor(pad), torch.tensor(valid), torch.tensor(robots),
        torch.tensor(ground), torch.ones(g, dtype=torch.bool),
        torch.tensor(dg), look_ahead_distance=2.0, inscribed_radius=0.5)
    for b in range(2):
        jp, ji = fn(pad[b], valid[b], robots[b], ground, np.ones(g, bool),
                    dg[b])
        assert int(pivot[b]) == int(jp) and int(i0[b]) == int(ji), b
    # robot 1's walk was pushed past the disk and the off-ground poses
    assert float(pad[1, int(pivot[1]), 0]) > float(pad[0, int(pivot[0]), 0])


def test_dwa_request_stale_and_window_replan_match_jax():
    """`test_dwa_planner.py:40-150` on the port, each path equal to the JAX
    manager's: a new goal plans in full, a stale one returns the cache, a
    new goal replans; ``activate_threading=False`` stops the recompute; an
    obstacle on the path makes the window replan detour (the final pose
    twice) and the cleared field relaxes it again."""
    ground = flat_ground_map(16, 4, 0.2)
    rt = GlobalPlannerRuntime(CFG, ground, device="cpu")
    jrt = JRuntime(JCFG, ground)
    mgr = tdwa.DWAGlobalPlanManager(rt, CFG.dwa_global_planner)
    jmgr = jdwa.DWAGlobalPlanManager(jrt, JCFG.dwa_global_planner)
    calls = {"n": 0}
    plan = rt.plan

    def counting(*a, **k):
        calls["n"] += 1
        return plan(*a, **k)
    rt.plan = counting
    free = np.full(len(ground), FREE, np.float32)
    start = np.array([-7.0, 0.0, 0.0], np.float32)
    goal = np.array([7.0, 0.0, 0.0], np.float32)

    def same(a, b):
        np.testing.assert_array_equal(a.positions, b.positions)
        np.testing.assert_allclose(a.quats, b.quats, atol=1e-6, rtol=0)

    p1 = mgr.request(goal, IDQ, start, free)
    same(p1, jmgr.request(goal, IDQ, start, free))
    assert calls["n"] == 1 and np.abs(p1.positions[:, 1]).max() < 0.5
    assert mgr.request(goal, IDQ, start, free) is p1 and calls["n"] == 1
    robot = np.array([-6.0, 0.0, 0.0], np.float32)
    blocked = obstacle_field(ground, (-4.5, 0.0))
    mgr.maybe_recompute(robot, blocked, now=1.0)
    jmgr.maybe_recompute(robot, blocked, now=1.0)
    same(mgr.dwa_path, jmgr.dwa_path)
    d = np.linalg.norm(mgr.dwa_path.positions[:, :2] - [-4.5, 0.0], axis=1)
    assert d.min() >= 0.35 and np.abs(mgr.dwa_path.positions[:, 1]).max() > 0.5
    assert np.array_equal(mgr.dwa_path.positions[-1],
                          mgr.dwa_path.positions[-2])
    mgr.maybe_recompute(robot, free, now=1.05)       # within 10 Hz: no-op
    assert calls["n"] == 2
    mgr.maybe_recompute(robot, free, now=2.0)
    jmgr.maybe_recompute(robot, free, now=2.0)
    same(mgr.dwa_path, jmgr.dwa_path)
    assert np.abs(mgr.dwa_path.positions[:, 1]).max() < 0.5
    assert mgr.request(goal, IDQ, start, free) is mgr.dwa_path
    mgr.request(goal, IDQ, start, free, activate_threading=False)
    assert not mgr.threading_active
    n = calls["n"]
    mgr.maybe_recompute(robot, blocked, now=5.0)
    assert calls["n"] == n
    mgr.request(np.array([6.0, 1.0, 0.0], np.float32), IDQ, start, free)
    assert calls["n"] == n + 1 and mgr.dwa_path is None


# ---------------------------------------------------------------------------
# plan managers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("action", ["get_dwa_plan", "get_plan"])
def test_sync_manager_matches_jax(runtimes, action):
    """The inline manager at 5 Hz over ticks at 10 Hz, both actions: the
    same plans surface on the same ticks as from the JAX manager, an
    obstacle moves them, and stop() ends the queries."""
    ground, rt, jrt = runtimes
    mgr = SyncPlanManager(tdwa.DWAGlobalPlanManager(
        rt, CFG.dwa_global_planner), 5.0, action=action)
    jmgr = JSync(jdwa.DWAGlobalPlanManager(jrt, JCFG.dwa_global_planner),
                 5.0, action=action)
    goal = np.array([2.6, 0.0, 0.0], np.float32)
    for m in (mgr, jmgr):
        m.set_goal(goal, IDQ)
    taken = 0
    for k in range(6):
        robot = np.array([-2.6 + 0.1 * k, 0.0, 0.0], np.float32)
        dg = (obstacle_field(ground, (0.0, 0.0)) if k >= 3
              else np.full(len(ground), FREE, np.float32))
        mgr.offer(robot, torch.tensor(dg), 0.1 * k)
        jmgr.offer(robot, jnp.asarray(dg), 0.1 * k)
        got, want = mgr.take_plan(), jmgr.take_plan()
        assert (got is None) == (want is None), k
        assert mgr.last_query_empty() == jmgr.last_query_empty()
        if got is not None:
            taken += 1
            np.testing.assert_array_equal(got.positions, want.positions)
    assert taken == 3
    mgr.stop()
    assert not mgr.dwa.threading_active
    mgr.offer(np.zeros(3, np.float32), torch.tensor(dg), 10.0)
    assert mgr.take_plan() is None


def wait_for_plan(mgr, seconds=60.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        plan = mgr.take_plan()
        if plan is not None:
            return plan
        time.sleep(0.02)
    return None


def test_async_manager_plans_off_thread(runtimes):
    """`test_plan_manager.py:82-113`: the worker plans from the offered
    snapshot, counts what it publishes, and publishes nothing after
    stop()."""
    ground, rt, _ = runtimes
    dwa = tdwa.DWAGlobalPlanManager(rt, CFG.dwa_global_planner)
    mgr = AsyncPlanManager(dwa, query_frequency=20.0)
    try:
        free = torch.full((len(ground),), FREE)
        mgr.set_goal(np.array([2.6, 0.0, 0.0], np.float32), IDQ)
        mgr.offer(np.array([-2.6, 0.0, 0.0], np.float32), free, now=0.0)
        plan = wait_for_plan(mgr)
        assert plan is not None and mgr.published >= 1
        assert threading.current_thread() is not mgr._thread
        assert np.linalg.norm(plan.positions[-1] - [2.6, 0.0, 0.0]) < 0.5
        mgr.stop()
        time.sleep(0.2)
        mgr.take_plan()
        mgr.offer(np.array([-2.0, 0.0, 0.0], np.float32), free, now=1.0)
        time.sleep(0.3)
        assert mgr.take_plan() is None and not dwa.threading_active
    finally:
        mgr.close()


def test_async_set_goal_race_never_publishes_stale_goal(runtimes):
    """`test_plan_manager.py:147-196`: swap goals against the worker; any
    plan taken as fresh leads to the goal current when it is taken."""
    ground, rt, _ = runtimes
    mgr = AsyncPlanManager(tdwa.DWAGlobalPlanManager(
        rt, CFG.dwa_global_planner), query_frequency=200.0)
    goals = [np.array([2.6, 0.0, 0.0], np.float32),
             np.array([-2.6, 0.6, 0.0], np.float32),
             np.array([0.0, -1.8, 0.0], np.float32)]
    try:
        free = torch.full((len(ground),), FREE)
        robot = np.zeros(3, np.float32)
        mgr.set_goal(goals[0], IDQ)
        mgr.offer(robot, free, now=0.0)
        assert wait_for_plan(mgr) is not None
        checked, i = 0, 0
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline and checked < 6:
            i += 1
            mgr.set_goal(goals[i % 3], IDQ)
            mgr.offer(robot, free, now=float(i))
            t_poll = time.monotonic() + 0.25
            while time.monotonic() < t_poll:
                plan = mgr.take_plan()
                if plan is not None:
                    err = np.linalg.norm(plan.positions[-1] - mgr.goal[0])
                    assert err < 0.5, (plan.positions[-1], mgr.goal[0])
                    checked += 1
                time.sleep(0.005)
        assert checked >= 3
    finally:
        mgr.close()


# ---------------------------------------------------------------------------
# MoveBaseDriver's host gates
# ---------------------------------------------------------------------------

def test_driver_gates_zero_velocity_and_hold_state():
    """`test_plan_manager.py::test_gates_zero_velocity_and_hold_state` on
    the port, each tick's decision equal to the JAX driver's: a stale TF or
    sensor never commands the base and holds the decision."""
    ground = flat_ground_map(6, 4, 0.25)
    drv = MoveBaseDriver(CFG, ground, device="cpu")
    jdrv = JDriver(JCFG, ground)
    for d in (drv, jdrv):
        d.set_goal([2.5, 0.0, 0.0])
    k = CFG.local_planner.max_obstacle_points
    obs, valid = torch.zeros(1, k, 3), torch.zeros(1, k, dtype=torch.bool)
    pos = np.array([-2.5, 0.0, 0.0], np.float32)
    gates = [{}] * 6 + [{"tf_ok": False}, {"sensor_ok": False}, {}]
    decisions = []
    for i, gate in enumerate(gates):
        got = drv.tick(pos, IDQ, 0.0, 0.0, obs, valid, i * 0.1, **gate)
        want = jdrv.tick(pos, jnp.asarray(IDQ), 0.0, 0.0, jnp.zeros((k, 3)),
                         jnp.zeros(k, bool), i * 0.1, **gate)
        assert int(got[2]) == int(want[2]) and got[3:] == want[3:], i
        np.testing.assert_allclose(got[:2], want[:2], atol=1e-5)
        if gate:
            assert got[:2] == (0.0, 0.0)
        decisions.append(got[2])
    assert decisions[6] == decisions[7] == decisions[5]
    assert decisions[5] in (Decision.D_ALIGN_HEADING, Decision.D_CONTROLLING)
    assert int(JDecision.D_CONTROLLING) == int(Decision.D_CONTROLLING)


# ---------------------------------------------------------------------------
# the session, closed loop, against the JAX session
# ---------------------------------------------------------------------------

def small_scenario():
    cfg = entry.session_config(16, 180, 32, 16, 2, 4, 32)
    return entry.session_scenario(
        cfg, size=(6.0, 4.0), room_half=2.8, start=(-1.4, 0.0, 0.0),
        goal=(2.2, 0.0, 0.0), wall=((-0.1, -0.6, 0.0), (0.1, 0.6, 1.2)),
        no_entry=(-0.5, 0.5, 0.8, 1.8), slow_from=1.0, depth_points=128,
        scan_rings=12, scan_cols=120)


SESSION_TICKS = 12


@pytest.fixture(scope="module")
def session_chain():
    """The port's and the JAX package's session through the same 12
    inputs: the JAX session is ticked inside the port chain's input
    callback, on the pose and command the port's chain carries."""
    sc = small_scenario()
    sess = entry.make_session(sc, "cpu")
    js = jax_session(sc)
    js.set_goal(sc.goal)
    ticks = []

    def inputs(t, pos, yaw):
        pts, mask, quat, frames = entry.session_inputs(sc, pos, yaw)
        now = t * entry.SESSION_DT
        for c, (cp, cq, dp) in enumerate(frames):
            js.push_depth_observation(c, cp, cq, dp, now)
        v, w = ticks[-1]["port"][:2] if ticks else (0.0, 0.0)
        for s in (sess, js):
            s.driver.last_planner_state = -1
            s.driver.plan_manager.dwa.last_pivot = -1
        jout = js.tick(pts, mask, pos, quat, v, w, now)
        ticks.append({"jax": jout, "jax_fields": session_fields(js),
                      "jax_composed": np.asarray(js.composed_dgraph),
                      "jax_ps": js.driver.last_planner_state,
                      "jax_pivot": js.driver.plan_manager.dwa.last_pivot})
        return pts, mask, quat, frames

    def on_tick(t, out):
        ticks[t].update(port=out, port_fields=session_fields(sess),
                        port_composed=sess.composed_dgraph.numpy(),
                        port_ps=sess.driver.last_planner_state,
                        port_pivot=sess.driver.plan_manager.dwa.last_pivot)
    chain = entry.run_session_chain(sess, sc, SESSION_TICKS, inputs=inputs,
                                    on_tick=on_tick)
    return sc, sess, js, chain, ticks


def test_session_chain_matches_jax(session_chain):
    """12 ticks of the small scenario: per tick the command within 1e-5;
    decision, done, succeeded, the simple generator's state, the adopted
    plan's pose count and the DWA pivot exactly; the composed field within
    1e-5; the marking and depth grids exactly."""
    sc, sess, js, chain, ticks = session_chain
    assert len(ticks) == SESSION_TICKS
    for t, r in enumerate(ticks):
        got, want = r["port"], r["jax"]
        np.testing.assert_allclose(got[:2], want[:2], atol=1e-5, err_msg=t)
        assert int(got[2]) == int(want[2]) and got[3:] == want[3:], t
        assert r["port_ps"] == r["jax_ps"], t
        assert r["port_pivot"] == r["jax_pivot"], t
        pf, jf = r["port_fields"], r["jax_fields"]
        assert len(pf["plan_pos"]) == len(jf["plan_pos"]), t
        np.testing.assert_allclose(r["port_composed"], r["jax_composed"],
                                   atol=1e-5, err_msg=t)
        for k in ("marking_grid_idx", "depth_marking_grid_idx",
                  "depth_buffer_stamp", "depth_buffer_head"):
            np.testing.assert_array_equal(pf[k], jf[k], err_msg=f"{t} {k}")
    decisions = [int(r["port"][2]) for r in ticks]
    assert int(Decision.D_ALIGN_HEADING) in decisions
    assert any(r["port_pivot"] >= 0 for r in ticks)
    last = ticks[-1]["port_fields"]
    assert len(last["depth_marking_grid_idx"]) > 0
    # the no-entry zone and the wall are lethal in the composed field
    lethal = sc.ground[ticks[-1]["port_composed"] < 0.5]
    assert (lethal[:, 1] > 0.7).any() and (np.abs(lethal[:, 0]) < 0.3).any()


def test_port_session_state_round_trips_through_restore(session_chain):
    """The JAX session's state after the chain, carried into a fresh port
    session through ``port_session_state`` and ``restore_state``, reads
    back as the same fields; the restored session's next tick equals the
    JAX session's."""
    sc, sess, js, chain, ticks = session_chain
    fields = session_fields(js)
    buf = js.depth_buffer
    fresh = entry.make_session(sc, "cpu")
    fresh.restore_state(port_session_state(fields, "cpu",
                                           np.asarray(buf.points)))
    back = session_fields(fresh)
    assert back.keys() == fields.keys()
    for k, v in fields.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    np.testing.assert_array_equal(fresh.depth_buffer.points[0].numpy(),
                                  np.asarray(buf.points))
    # the next tick from the carried state
    pos = chain.pos[-1] + np.array([0.0, 0.0, 0.0], np.float32)
    pos, yaw = entry.step_pose(chain.pos[-1], float(chain.yaw[-1]),
                               *ticks[-1]["jax"][:2])
    pts, mask, quat, frames = entry.session_inputs(sc, pos, yaw)
    now = SESSION_TICKS * entry.SESSION_DT
    for c, (cp, cq, dp) in enumerate(frames):
        js.push_depth_observation(c, cp, cq, dp, now)
        fresh.push_depth_observation(c, cp, cq, dp, now)
    v, w = ticks[-1]["jax"][:2]
    want = js.tick(pts, mask, pos, quat, v, w, now)
    got = fresh.tick(pts, mask, pos, quat, v, w, now)
    np.testing.assert_allclose(got[:2], want[:2], atol=1e-5)
    assert int(got[2]) == int(want[2]) and got[3:] == want[3:]
    # a checkpoint of the port restores the port
    ck = fresh.checkpoint_state()
    again = entry.make_session(sc, "cpu")
    again.restore_state(ck)
    assert torch.equal(again.marking.grid, fresh.marking.grid)
    assert torch.equal(again.depth_buffer.points, fresh.depth_buffer.points)
    assert again.driver.decision == fresh.driver.decision


def test_jax_config_round_trip():
    cfg = entry.session_config(16, 180, 32, 16, 2, 4, 32)
    j = jax_config(cfg)
    assert dataclasses.asdict(j) == dataclasses.asdict(cfg)
