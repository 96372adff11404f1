"""The port's move-base FSM and rotate recovery (dddmr_navigation_tpu_torch.
control) against the JAX package and the sequential FSM oracle, on the CPU.

Tolerances: exact for decisions, command sources, requests, counters and
flags; the FSM's clocks are f32 and compared exactly too; recovery
commands within 1e-6 rad/s.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddmr_navigation_tpu.config import LocalPlannerConfig, MoveBaseConfig
from dddmr_navigation_tpu.control import fsm as jfsm
from dddmr_navigation_tpu.control import recovery as jrec
from dddmr_navigation_tpu.geometry import quat_from_yaw as j_quat_from_yaw

from dddmr_navigation_tpu_torch.control import fsm as tfsm
from dddmr_navigation_tpu_torch.control import recovery as trec
from dddmr_navigation_tpu_torch.interop import config_from, tensor

from oracles.fsm_oracle import FSMOracle

torch.set_num_threads(1)

B, T = 12, 80
# small patiences so that every timeout fires within the stream
MB = MoveBaseConfig(planner_patience=1.0, controller_patience=0.6,
                    oscillation_distance=0.5, oscillation_angle=1.0,
                    oscillation_patience=2.0, waiting_patience=0.5,
                    no_plan_retry_num=2)


def input_stream(seed=0):
    """Seeded per-tick FSM inputs for B robots over T ticks (numpy)."""
    rng = np.random.default_rng(seed)
    pos = np.cumsum(rng.normal(0, 0.08, (T, B, 3)), axis=0).astype(np.float32)
    yaw = np.cumsum(rng.normal(0, 0.2, (T, B)), axis=0).astype(np.float32)
    # planner states, TRAJECTORY_FOUND the most common
    ps_p = [0.02, 0.1, 0.2, 0.02, 0.5, 0.08, 0.08]
    stream = []
    for t in range(T):
        stream.append(dict(
            now=np.float32(t) * np.float32(0.1),
            robot_pos=pos[t], robot_yaw=yaw[t],
            has_new_plan=rng.random(B) < 0.8,
            plan_empty=rng.random(B) < 0.15,
            goal_reached=rng.random(B) < 0.1,
            initial_heading_aligned=rng.random(B) < 0.5,
            goal_heading_aligned=rng.random(B) < 0.3,
            ps_simple=rng.choice(7, B, p=ps_p).astype(np.int32),
            ps_rotate=rng.choice(7, B, p=ps_p).astype(np.int32),
            recovery_active=rng.random(B) < 0.3,
            recovery_succeed=rng.random(B) < 0.6))
    return stream


@pytest.fixture(scope="module")
def fsm_runs():
    """The stream through JAX's vmapped fsm_step and the port's, state and
    outputs per tick as numpy."""
    stream = input_stream()
    step = jax.jit(jax.vmap(lambda s, x: jfsm.fsm_step(MB, s, x),
                            in_axes=(0, jfsm.FSMInputs(
                                None, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0))))
    js = jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                *[jfsm.init_fsm_state() for _ in range(B)])
    ts = tfsm.init_fsm_state(B, device="cpu")
    mb = config_from(MB)
    want, got = [], []
    for x in stream:
        js, jo = step(js, jfsm.FSMInputs(**x))
        ts, to = tfsm.fsm_step(mb, ts, tfsm.FSMInputs(
            **{k: tensor(v, "cpu") for k, v in x.items()}))
        want.append(jax.tree_util.tree_map(np.asarray, (js, jo)))
        got.append(((tfsm.FSMState(*(v.numpy() for v in ts))),
                    tfsm.FSMOutputs(*(v.numpy() for v in to))))
    return stream, want, got


def test_fsm_matches_jax(fsm_runs):
    _, want, got = fsm_runs
    for t, ((ws, wo), (gs, go)) in enumerate(zip(want, got)):
        for f in tfsm.FSMState._fields:
            np.testing.assert_array_equal(getattr(gs, f), getattr(ws, f),
                                          err_msg=f"tick {t} {f}")
        for f in tfsm.FSMOutputs._fields:
            np.testing.assert_array_equal(getattr(go, f), getattr(wo, f),
                                          err_msg=f"tick {t} {f}")


def test_fsm_stream_covers_every_branch(fsm_runs):
    """The stream reaches every decision state after d_initial, both
    requests and every command source, so the comparisons above can
    fail."""
    _, _, got = fsm_runs
    dec = np.stack([s.decision for s, _ in got])
    assert set(np.unique(dec)) == set(range(1, 10)), np.unique(dec)
    cmd = np.stack([o.cmd_source for _, o in got])
    assert set(np.unique(cmd)) == {0, 1, 2}
    assert np.stack([o.request_recovery for _, o in got]).any()
    assert np.stack([o.request_plan_query for _, o in got]).any()
    assert (np.stack([s.no_plan_recovery_count for s, _ in got]) > 0).any()


def test_fsm_matches_oracle(fsm_runs):
    stream, _, got = fsm_runs
    for b in range(B):
        oracle = FSMOracle(MB)
        for t, x in enumerate(stream):
            out = oracle.step(
                now=float(x["now"]), robot_pos=tuple(x["robot_pos"][b]),
                robot_yaw=float(x["robot_yaw"][b]),
                **{k: (bool(x[k][b]) if x[k].dtype == bool else int(x[k][b]))
                   for k in ("has_new_plan", "plan_empty", "goal_reached",
                             "initial_heading_aligned",
                             "goal_heading_aligned", "ps_simple",
                             "ps_rotate", "recovery_active",
                             "recovery_succeed")})
            s, o = got[t]
            assert s.decision[b] == out["decision"], (b, t)
            assert o.cmd_source[b] == out["cmd_source"], (b, t)


def test_fsm_patience_in_f32():
    """0.9 s − 0.3 s in f32 is 0.6 s to the last bit, so a 0.6 s controller
    patience has not run out; in f64 it would have (0.6000000000000001).
    The port answers as JAX does: ALL_TRAJECTORIES_FAIL in d_controlling
    replans instead of requesting a recovery."""
    x = dict(now=np.float32(0.9), robot_pos=np.zeros((1, 3), np.float32),
             robot_yaw=np.zeros(1, np.float32),
             has_new_plan=np.ones(1, bool), plan_empty=np.zeros(1, bool),
             goal_reached=np.zeros(1, bool),
             initial_heading_aligned=np.ones(1, bool),
             goal_heading_aligned=np.zeros(1, bool),
             ps_simple=np.full(1, 2, np.int32), ps_rotate=np.full(1, 4, np.int32),
             recovery_active=np.zeros(1, bool),
             recovery_succeed=np.zeros(1, bool))
    assert np.float32(0.9) - np.float32(0.3) <= np.float32(0.6)
    assert 0.9 - 0.3 > 0.6
    s0 = jfsm.init_fsm_state()._replace(
        decision=jnp.asarray(int(jfsm.Decision.D_CONTROLLING), jnp.int32),
        last_valid_control=jnp.float32(0.3))
    js, jo = jax.jit(lambda s, x: jfsm.fsm_step(MB, s, x))(
        s0, jfsm.FSMInputs(**{k: (v if k == "now" else v[0])
                               for k, v in x.items()}))
    ts0 = tfsm.init_fsm_state(1, device="cpu")._replace(
        decision=torch.full((1,), int(tfsm.Decision.D_CONTROLLING),
                            dtype=torch.int32),
        last_valid_control=torch.full((1,), 0.3))
    ts, to = tfsm.fsm_step(config_from(MB), ts0, tfsm.FSMInputs(
        **{k: tensor(v, "cpu") for k, v in x.items()}))
    assert int(ts.decision[0]) == int(js.decision) == tfsm.Decision.D_PLANNING
    assert not bool(to.request_recovery[0]) and not bool(jo.request_recovery)


# ---------------------------------------------------------------------------
# rotate recovery
# ---------------------------------------------------------------------------

LP = LocalPlannerConfig(max_obstacle_points=96, collision_obstacle_chunk=16,
                        collision_near_k=64)


def recovery_case():
    """Five robots: boxed in by a ring (every rotation collides), free at
    the start, half way round, back home after the half turn, and beside a
    wall inside the circle the footprint's corners sweep (both rotations
    collide)."""
    b = 5
    start = np.asarray([0.3, -1.0, 2.0, 0.0, 1.5], np.float32)
    yaw = np.asarray([0.3, -1.0, 2.0 + np.pi - 0.1, 0.2, 1.5],
                     np.float32)
    got_180 = np.asarray([False, False, False, True, False])
    pos = np.stack([np.arange(b) * 3.0, np.zeros(b), np.zeros(b)],
                   1).astype(np.float32)
    obs = np.zeros((b, 96, 3), np.float32)
    mask = np.zeros((b, 96), bool)
    ang = np.linspace(-np.pi, np.pi, 48, endpoint=False)
    ring = np.stack([0.45 * np.cos(ang), 0.45 * np.sin(ang),
                     np.full_like(ang, 0.1)], 1)
    ring = np.concatenate([ring, ring + [0, 0, 0.25]])
    obs[0] = pos[0] + ring
    mask[0] = True
    wall = np.stack([np.full(20, 0.52), np.linspace(-1, 1, 20),
                     np.full(20, 0.3)], 1)
    obs[4, :20] = pos[4] + wall
    mask[4, :20] = True
    return start, yaw, got_180, pos, obs, mask


def test_rotate_recovery_step_matches_jax():
    start, yaw, got_180, pos, obs, mask = recovery_case()
    quat = np.asarray(j_quat_from_yaw(yaw))
    active = np.ones(len(yaw), bool)

    def one(s, g, a, p, q, o, m):
        rec = jrec.RotateRecoveryState(start_yaw=s, got_180=g, active=a)
        return jrec.rotate_recovery_step(LP, rec, p, q, o, m)
    (wrec, wwz, wdone, wfail) = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.vmap(one))(start, got_180, active, pos, quat,
                                           obs, mask))
    t = lambda x: tensor(x, "cpu")  # noqa: E731
    rec = trec.RotateRecoveryState(t(start), t(got_180), t(active))
    grec, gwz, gdone, gfail = trec.rotate_recovery_step(
        config_from(LP), rec, t(pos), t(quat), t(obs), t(mask))
    np.testing.assert_array_equal(gdone.numpy(), wdone)
    np.testing.assert_array_equal(gfail.numpy(), wfail)
    for f in trec.RotateRecoveryState._fields:
        np.testing.assert_array_equal(getattr(grec, f).numpy(),
                                      getattr(wrec, f), err_msg=f)
    np.testing.assert_allclose(gwz.numpy(), wwz, atol=1e-6)
    # the ring fails the recovery; the half turn sets got_180; home after
    # it is done; the free robot rotates on
    assert gfail.tolist() == [True, False, False, False, True]
    assert grec.got_180.tolist() == [False, False, True, True, False]
    assert gdone.tolist() == [False, False, False, True, False]
    assert gwz[1] != 0.0 and gwz[0] == 0.0 and gwz[3] == 0.0


def test_start_rotate_recovery_matches_jax():
    yaw = np.asarray([0.0, 1.0, -2.5, 3.1], np.float32)
    quat = np.asarray(j_quat_from_yaw(yaw))
    got = trec.start_rotate_recovery(tensor(quat, "cpu"))
    want = jax.vmap(jrec.start_rotate_recovery)(quat)
    np.testing.assert_allclose(got.start_yaw.numpy(), np.asarray(want.start_yaw),
                               atol=1e-7)
    assert got.active.all() and not got.got_180.any()
