"""The port's local-planner slice (dddmr_navigation_tpu_torch) against the
JAX package, module by module and tick by tick, on the CPU.

The same numpy inputs go through the JAX function and its port; the port's
kernel wrappers take their plain PyTorch versions here. Tolerances: exact
for masks, counts, indices and state codes; 1e-5 m for rollout positions
and 1e-6 rad for headings, since PyTorch's sin/cos/cumsum round differently
from XLA's at the ulp level; rtol/atol 1e-5 for critic scores.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddmr_navigation_tpu.config import LocalPlannerConfig
from dddmr_navigation_tpu import geometry as jgeo
from dddmr_navigation_tpu.planning.local import critics as jcrit
from dddmr_navigation_tpu.planning.local.sampler import (
    dd_simple_samples as j_dd_samples)
from dddmr_navigation_tpu.planning.local.rollout import rollout as j_rollout
from dddmr_navigation_tpu.planning.local.planner import (
    make_global_plan as j_make_plan, prune_plan as j_prune_plan,
    compute_velocity_command as j_tick, goal_reached as j_goal_reached)
from dddmr_navigation_tpu.parallel.fleet import (
    FleetState as JFleetState, fleet_tick as j_fleet_tick,
    integrate_fleet as j_integrate)

import dddmr_navigation_tpu_torch.geometry as tgeo
from dddmr_navigation_tpu_torch.planning.local import critics as tcrit
from dddmr_navigation_tpu_torch.planning.local.sampler import dd_simple_samples
from dddmr_navigation_tpu_torch.planning.local.rollout import rollout
from dddmr_navigation_tpu_torch.planning.local.planner import (
    GlobalPlan, PlannerState, make_global_plan, prune_plan,
    compute_velocity_command, goal_reached)
from dddmr_navigation_tpu_torch.parallel.fleet import (
    FleetState, fleet_tick, integrate_fleet)
from dddmr_navigation_tpu_torch.interop import (
    config_from, to_port, to_numpy, tensor)
from dddmr_navigation_tpu_torch import entry

torch.set_num_threads(1)
# Nothing on the tick is a matmul; TF32 stays off all the same.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                      "headline_tick0.npz")


def stack_plans(plans):
    return jax.tree_util.tree_map(lambda *x: jnp.stack(x), *plans)


def assert_best_index(port_idx, jax_idx, jax_costs, tol=1e-5):
    """Equal best indices, or a tie: the JAX costs at both indices agree
    within ``tol`` (a tie may flip between XLA's and PyTorch's rounding)."""
    port_idx, jax_idx = np.asarray(port_idx), np.asarray(jax_idx)
    for b in np.flatnonzero(port_idx != jax_idx):
        c = np.asarray(jax_costs)[b]
        gap = abs(float(c[port_idx[b]]) - float(c[jax_idx[b]]))
        assert gap <= tol, (b, port_idx[b], jax_idx[b], gap)
        warnings.warn(f"robot {b}: best index {port_idx[b]} vs JAX "
                      f"{jax_idx[b]}, a tie within {gap:.2e}")


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def test_se3_matches_jax():
    rng = np.random.default_rng(0)
    q1 = rng.normal(size=(16, 4)).astype(np.float32)
    q1 /= np.linalg.norm(q1, axis=-1, keepdims=True)
    q2 = rng.normal(size=(16, 4)).astype(np.float32)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    v[::3, 2] = 0.0                       # flat segments take the yaw branch
    a = rng.uniform(-4, 4, size=16).astype(np.float32)
    T = torch.as_tensor
    pairs = [
        (jgeo.quat_multiply(q1, q2), tgeo.quat_multiply(T(q1), T(q2))),
        (jgeo.quat_conjugate(q1), tgeo.quat_conjugate(T(q1))),
        (jgeo.quat_rotate(q1, v), tgeo.quat_rotate(T(q1), T(v))),
        (jgeo.quat_from_rpy(a, -a, 0.5 * a),
         tgeo.quat_from_rpy(T(a), -T(a), 0.5 * T(a))),
        (jgeo.quat_from_yaw(a), tgeo.quat_from_yaw(T(a))),
        (jgeo.yaw_from_quat(q1), tgeo.yaw_from_quat(T(q1))),
        (jgeo.normalize_angle(a), tgeo.normalize_angle(T(a))),
        (jgeo.quat_from_axis_angle(v, a), tgeo.quat_from_axis_angle(T(v), T(a))),
        (jgeo.slope_aware_quat(v), tgeo.slope_aware_quat(T(v))),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


# ---------------------------------------------------------------------------
# modules at a small size: B = 4, 5×5 samples, 16 steps, 64 obstacles,
# near-K 32, P = 32, plan length 64
# ---------------------------------------------------------------------------

SMALL = entry.headline_config(linear_samples=4, angular_samples=4,
                              max_num_steps=16, obstacles_n=64, near_k=32,
                              prune_len=32, plan_len=64)
CRITICS = ("collision", "stick_path", "pure_pursuit", "toward_global_plan",
           "shortest_angle", "twirling")


def small_inputs(seed=0, b=4, m=64):
    rng = np.random.default_rng(seed)
    xs = np.arange(0, 4.0, 0.1, dtype=np.float32)
    plans = np.stack([np.stack([xs, 0.3 * np.sin(xs + i) + 0.05 * i,
                                np.zeros_like(xs)], 1) for i in range(b)])
    plans[1, :, 2] = 0.05 * xs            # a ramp: slope-aware quaternions
    pos = np.stack([rng.uniform(0.0, 1.5, b), 0.3 * np.sin(rng.uniform(size=b)),
                    np.zeros(b)], 1).astype(np.float32)
    pos[3, 1] += 2.0                      # more than 1 m off: prune fails
    yaw = rng.uniform(-0.3, 0.3, b).astype(np.float32)
    v = rng.uniform(0.0, 0.9, b).astype(np.float32)
    w = rng.uniform(-0.4, 0.4, b).astype(np.float32)
    obs = (pos[:, None, :] + rng.uniform([0.3, -1.5, 0.0], [3.0, 1.5, 0.5],
                                         size=(b, m, 3))).astype(np.float32)
    obs_valid = rng.uniform(size=(b, m)) < 0.9
    obs_valid[2, 4:] = False              # under 5 points: collision gate off
    cap = np.asarray([-1.0, 0.3, -1.0, -1.0], np.float32)[:b]
    hd = rng.uniform(-0.5, 0.5, b).astype(np.float32)
    return plans, pos, yaw, v, w, obs, obs_valid, cap, hd


def jax_parts(cfg, plan, pos, quat, v, w, obs, obs_valid, cap, hd):
    """One robot through every stage of the JAX tick."""
    gen = cfg.generator
    pp, ok = j_prune_plan(cfg, plan, pos)
    samples, valid = j_dd_samples(gen, v, w, cap)
    r = j_rollout(samples, valid, pos, quat, sim_time=gen.sim_time,
                  sim_granularity=gen.sim_granularity,
                  angular_sim_granularity=gen.angular_sim_granularity,
                  min_vel_x=gen.limits.min_vel_x,
                  min_vel_theta=gen.limits.min_vel_theta,
                  max_vel_x=gen.limits.max_vel_x, max_steps=gen.max_num_steps)
    pw = cfg.critics.pure_pursuit
    scores = {
        "collision": jcrit.collision_scores(
            r, gen.cuboid, obs, obs_valid,
            obstacle_chunk=cfg.collision_obstacle_chunk,
            near_k=cfg.collision_near_k),
        "stick_path": jcrit.stick_path_scores(r, pp, 1.0),
        "pure_pursuit": jcrit.pure_pursuit_scores(
            r, pp, pw.translation_weight, pw.orientation_weight),
        "toward_global_plan": jcrit.toward_global_plan_scores(r, pp, 1.0),
        "shortest_angle": jcrit.shortest_angle_scores(r, hd, 1.0),
        "twirling": jcrit.twirling_scores(r, 1.0),
    }
    cmd = j_tick(cfg, plan, pos, quat, v, w, obs, obs_valid, cap, hd)
    return dict(pp=pp, ok=ok, samples=samples, valid=valid, r=r,
                scores=scores, cmd=cmd,
                goal=j_goal_reached(cfg, plan, pos))


def port_parts(cfg, plan, pos, quat, v, w, obs, obs_valid, cap, hd):
    """The fleet through every stage of the port's tick."""
    gen = cfg.generator
    pp, ok = prune_plan(cfg, plan, pos)
    samples, valid = dd_simple_samples(gen, v, w, cap)
    r = rollout(samples, valid, pos, quat, sim_time=gen.sim_time,
                sim_granularity=gen.sim_granularity,
                angular_sim_granularity=gen.angular_sim_granularity,
                min_vel_x=gen.limits.min_vel_x,
                min_vel_theta=gen.limits.min_vel_theta,
                max_vel_x=gen.limits.max_vel_x, max_steps=gen.max_num_steps)
    pw = cfg.critics.pure_pursuit
    scores = {
        "collision": tcrit.collision_scores(r, gen.cuboid, obs, obs_valid,
                                            near_k=cfg.collision_near_k),
        "stick_path": tcrit.stick_path_scores(r, pp, 1.0),
        "pure_pursuit": tcrit.pure_pursuit_scores(
            r, pp, pw.translation_weight, pw.orientation_weight),
        "toward_global_plan": tcrit.toward_global_plan_scores(r, pp, 1.0),
        "shortest_angle": tcrit.shortest_angle_scores(r, hd, 1.0),
        "twirling": tcrit.twirling_scores(r, 1.0),
    }
    cmd = compute_velocity_command(cfg, plan, pos, quat, v, w, obs,
                                   obs_valid, cap, hd)
    return dict(pp=pp, ok=ok, samples=samples, valid=valid, r=r,
                scores=scores, cmd=cmd, goal=goal_reached(cfg, plan, pos))


@pytest.fixture(scope="module")
def small():
    """(JAX parts, port parts) of one tick of the small fleet."""
    plans, pos, yaw, v, w, obs, obs_valid, cap, hd = small_inputs()
    cfg = SMALL
    jplans = stack_plans([j_make_plan(p, max_len=cfg.max_plan_len)
                          for p in plans])
    quat = np.asarray(jgeo.quat_from_yaw(yaw))
    fn = jax.jit(jax.vmap(lambda *a: jax_parts(cfg, *a)))
    want = jax.tree_util.tree_map(
        np.asarray, fn(jplans, pos, quat, v, w, obs, obs_valid, cap, hd))
    tplan = to_port(jax.tree_util.tree_map(np.asarray, jplans), GlobalPlan,
                    "cpu")
    got = to_numpy(port_parts(cfg, tplan, *(tensor(x, "cpu") for x in (
        pos, quat, v, w, obs, obs_valid, cap, hd))))
    return want, got


def test_make_global_plan_matches_jax():
    plans = small_inputs()[0]
    want = [j_make_plan(p, max_len=64) for p in plans]
    got = to_numpy(make_global_plan(plans, max_len=64, device="cpu"))
    for b, w in enumerate(want):
        np.testing.assert_array_equal(got.valid[b], np.asarray(w.valid))
        assert got.count[b] == int(w.count)
        np.testing.assert_array_equal(got.positions[b], np.asarray(w.positions))
        np.testing.assert_allclose(got.quats[b], np.asarray(w.quats),
                                   atol=1e-6)


def test_sampler_matches_jax(small):
    want, got = small
    np.testing.assert_array_equal(got["samples"], want["samples"])
    np.testing.assert_array_equal(got["valid"], want["valid"])


def test_rollout_matches_jax(small):
    (want, got) = small
    wr, gr = want["r"], got["r"]
    np.testing.assert_array_equal(gr.num_steps, wr.num_steps)
    np.testing.assert_array_equal(gr.valid, wr.valid)
    np.testing.assert_array_equal(gr.step_valid, wr.step_valid)
    np.testing.assert_allclose(gr.dt, wr.dt, rtol=1e-6)
    np.testing.assert_allclose(gr.positions, wr.positions, atol=1e-5)
    np.testing.assert_allclose(gr.theta, wr.theta, atol=1e-6)


def test_prune_plan_matches_jax(small):
    want, got = small
    wp, gp = want["pp"], got["pp"]
    np.testing.assert_array_equal(got["ok"], want["ok"])
    assert not got["ok"][3] and got["ok"][:3].all()
    np.testing.assert_array_equal(gp.count, wp.count)
    np.testing.assert_array_equal(gp.valid, wp.valid)
    np.testing.assert_array_equal(gp.intensity, wp.intensity)
    np.testing.assert_allclose(gp.positions, wp.positions, atol=1e-6)
    np.testing.assert_allclose(gp.quats, wp.quats, atol=1e-6)
    np.testing.assert_array_equal(got["goal"], want["goal"])


@pytest.mark.parametrize("critic", CRITICS)
def test_critic_matches_jax(small, critic):
    want, got = small
    np.testing.assert_allclose(got["scores"][critic], want["scores"][critic],
                               rtol=1e-5, atol=1e-5)
    if critic == "collision":
        assert (want["scores"][critic] < 0).any()      # something collides


def test_scores_and_command_match_jax(small):
    want, got = small
    wc, gc = want["cmd"], got["cmd"]
    np.testing.assert_array_equal(gc.rejected, wc.rejected)
    np.testing.assert_allclose(gc.costs, wc.costs, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(gc.state, wc.state)
    assert_best_index(gc.best_index, wc.best_index, wc.costs)
    np.testing.assert_allclose(gc.vx, wc.vx, atol=1e-5)
    np.testing.assert_allclose(gc.wz, wc.wz, atol=1e-5)
    assert gc.state[3] == PlannerState.PRUNE_PLAN_FAIL


def test_unported_options_raise():
    """Every generator and critic of the local planner is ported now: the
    omni generator and the collision_min_max critic run, and only an
    unknown generator raises."""
    args = make_global_plan(np.zeros((1, 4, 3)), max_len=8,
                            device="cpu"), *(
        torch.zeros(s) for s in ((1, 3), (1, 4), (1,), (1,), (1, 8, 3)))
    mask = torch.ones(1, 8, dtype=bool)
    with pytest.raises(ValueError, match="unknown generator"):
        compute_velocity_command(SMALL, *args, mask, generator="ackermann")
    cmd = compute_velocity_command(SMALL, *args, mask,
                                   generator="omni_drive_simple")
    assert cmd.rollouts.samples.shape[-1] == 3
    from dddmr_navigation_tpu.config import CriticConfig, CriticsConfig
    cfg = config_from(LocalPlannerConfig(critics=CriticsConfig(
        collision_min_max=CriticConfig(weight=1.0))))
    cmd = compute_velocity_command(cfg, *args, mask)
    assert cmd.state.shape == (1,)


# ---------------------------------------------------------------------------
# whole ticks at the default LocalPlannerConfig: the inputs of
# test_local_planner.py's tick tests, one robot each, batched in the port
# ---------------------------------------------------------------------------

def tick_cases():
    ys = np.arange(-0.7, 1.0, 0.1)
    zs = np.arange(0.0, 0.6, 0.1)
    wall = np.array([[1.2, y, z] for y in ys for z in zs], np.float32)
    ring = np.array([[0.55 * np.cos(a), 0.55 * np.sin(a), 0.3]
                     for a in np.arange(0, 2 * np.pi, 0.2)], np.float32)
    ident = np.asarray([0.0, 0.0, 0.0, 1.0], np.float32)
    cases = {
        "no_obstacles": ([0.0, 0.0, 0.0], ident, 0.0, 0.0, np.zeros((0, 3))),
        "obstacle_wall": ([0.0, 0.0, 0.0], ident, 0.5, 0.0, wall),
        "boxed_in": ([0.0, 0.0, 0.0], ident, 0.3, 0.0, ring),
    }
    rng = np.random.default_rng(3)
    for trial in range(4):
        v = float(rng.uniform(0.0, 0.9))
        w = float(rng.uniform(-0.4, 0.4))
        x = float(rng.uniform(0.0, 3.0))
        yaw = float(rng.uniform(-0.3, 0.3))
        obstacles = rng.uniform([-1, -2, 0], [5, 2, 0.5],
                                size=(40, 3)).astype(np.float32)
        cases[f"moving_{trial}"] = (
            [x, 0.02, 0.0], np.asarray(jgeo.quat_from_yaw(jnp.float32(yaw))),
            v, w, obstacles)
    return cases


TICK_CASES = tick_cases()


@pytest.fixture(scope="module")
def default_ticks():
    cfg = LocalPlannerConfig()
    n = 512
    pts = np.stack([np.arange(60) * 0.1, np.zeros(60), np.zeros(60)],
                   1).astype(np.float32)
    plan = j_make_plan(pts, max_len=cfg.max_plan_len)
    tick = jax.jit(j_tick, static_argnums=(0, 10))
    rows = []
    for pos, quat, v, w, ob in TICK_CASES.values():
        obs = np.zeros((n, 3), np.float32)
        mask = np.zeros((n,), bool)
        obs[:len(ob)] = ob
        mask[:len(ob)] = True
        rows.append((np.asarray(pos, np.float32), np.asarray(quat, np.float32),
                     np.float32(v), np.float32(w), obs, mask))
    want = [tick(cfg, plan, *map(jnp.asarray, r), -1.0, 0.0) for r in rows]
    b = len(rows)
    plan_np = jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.asarray(x), (b,) + x.shape), plan)
    cols = [np.stack(c) for c in zip(*rows)]
    got = compute_velocity_command(
        config_from(cfg), to_port(plan_np, GlobalPlan, "cpu"),
        *(tensor(c, "cpu") for c in cols))
    return want, to_numpy(got)


@pytest.mark.parametrize("case", list(TICK_CASES))
def test_tick_matches_jax(default_ticks, case):
    want_all, got = default_ticks
    i = list(TICK_CASES).index(case)
    want = want_all[i]
    assert got.state[i] == int(want.state)
    assert_best_index(got.best_index[i:i + 1], [int(want.best_index)],
                      np.asarray(want.costs)[None])
    assert abs(got.vx[i] - float(want.vx)) <= 1e-5
    assert abs(got.wz[i] - float(want.wz)) <= 1e-5
    np.testing.assert_array_equal(got.rejected[i], np.asarray(want.rejected))
    np.testing.assert_allclose(got.costs[i], np.asarray(want.costs),
                               rtol=1e-5, atol=1e-5)
    if case == "boxed_in":
        assert got.state[i] == PlannerState.ALL_TRAJECTORIES_FAIL
        assert got.vx[i] == 0.0


def test_entry_matches_graft_entry():
    import __graft_entry__ as graft
    fn, args = graft.entry()
    want = [np.asarray(x) for x in jax.jit(fn)(*args)]
    tfn, targs = entry.entry("cpu")
    got = [x.numpy()[0] for x in tfn(*targs)]
    assert got[2] == want[2] == PlannerState.TRAJECTORY_FOUND
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the slice: a 5-tick fleet chain at B = 4, from one state carried across
# ---------------------------------------------------------------------------

def test_fleet_chain_matches_jax():
    cfg = entry.headline_config(4, 4, 16, 64, 32, 32, 128)
    b, ticks = 4, 5
    plans_np, obs, obs_valid, pos = entry.headline_numpy(b, 64)
    jplans = stack_plans([j_make_plan(p, max_len=cfg.max_plan_len)
                          for p in plans_np])
    jstate = JFleetState(pos=jnp.asarray(pos),
                         quat=jnp.tile(jgeo.quat_from_yaw(jnp.float32(0.0)),
                                       (b, 1)),
                         v=jnp.zeros((b,)), w=jnp.zeros((b,)))
    dt = 1.0 / cfg.controller_frequency

    @jax.jit
    def jstep(state, plans, obs, obs_valid):
        vx, wz, codes, _ = j_fleet_tick(cfg, plans, state, obs, obs_valid)
        return j_integrate(state, vx, wz, dt), codes

    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tstate = to_port(as_np(jstate), FleetState, "cpu")
    tplans = to_port(as_np(jplans), GlobalPlan, "cpu")
    tobs, tvalid = tensor(obs, "cpu"), tensor(obs_valid, "cpu")
    for t in range(ticks):
        jstate, codes = jstep(jstate, jplans, jnp.asarray(obs),
                              jnp.asarray(obs_valid))
        cmd = fleet_tick(cfg, tplans, tstate, tobs, tvalid)
        tstate = integrate_fleet(tstate, cmd.vx, cmd.wz, dt)
        np.testing.assert_array_equal(cmd.state.numpy(), np.asarray(codes),
                                      err_msg=f"tick {t}")
    assert (np.asarray(codes) == PlannerState.TRAJECTORY_FOUND).all()
    np.testing.assert_allclose(tstate.pos.numpy(), np.asarray(jstate.pos),
                               atol=1e-4)
    np.testing.assert_allclose(tstate.quat.numpy(), np.asarray(jstate.quat),
                               atol=1e-4)


def test_tracked_integration_matches_jax():
    """integrate_fleet through track_twist (acceleration-limited), with
    commands that speed up, brake past the floor and turn past the limit."""
    limits = LocalPlannerConfig().generator.limits
    rng = np.random.default_rng(5)
    b, dt = 8, 0.1
    pos = rng.uniform(-2, 2, size=(b, 3)).astype(np.float32)
    quat = np.asarray(jgeo.quat_from_yaw(rng.uniform(-3, 3, b)
                                         .astype(np.float32)))
    v = rng.uniform(0.0, 1.0, b).astype(np.float32)
    w = rng.uniform(-0.8, 0.8, b).astype(np.float32)
    vx = rng.uniform(-0.5, 1.5, b).astype(np.float32)
    wz = rng.uniform(-1.5, 1.5, b).astype(np.float32)
    want = j_integrate(JFleetState(pos, quat, v, w), vx, wz, dt, limits)
    got = integrate_fleet(FleetState(*(tensor(x, "cpu")
                                       for x in (pos, quat, v, w))),
                          tensor(vx, "cpu"), tensor(wz, "cpu"), dt,
                          config_from(limits))
    for field in FleetState._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   atol=1e-6, err_msg=field)
    assert not np.allclose(got.v.numpy(), vx)     # the limits did act


def test_run_chain_carries_state():
    cfg = entry.headline_config(4, 4, 16, 64, 32, 32, 128)
    plans, state, obs, obs_valid = entry.headline_inputs(cfg, 3, "cpu")
    chain = entry.run_chain(cfg, plans, state, obs, obs_valid, ticks=3)
    assert chain.state.shape == chain.best_index.shape == (3, 3)
    assert chain.found.tolist() == [3, 3, 3]
    step = state
    for t in range(3):
        step, cmd = entry.tick(cfg, plans, step, obs, obs_valid)
        assert torch.equal(cmd.vx, chain.vx[t])
    assert torch.equal(step.pos, chain.final.pos)
    assert (chain.final.pos[:, 0] > state.pos[:, 0]).all()


def test_headline_tick0_matches_golden():
    """The port's plain path at full headline width against the JAX
    package's tick 0 (tools/make_torch_golden.py)."""
    g = np.load(GOLDEN)
    cfg = entry.headline_config()
    plans, state, obs, obs_valid = entry.headline_inputs(cfg, 64, "cpu")
    cmd = to_numpy(fleet_tick(cfg, plans, state, obs, obs_valid))
    np.testing.assert_array_equal(cmd.state, g["state"])
    assert_best_index(cmd.best_index, g["best_index"], g["costs"])
    np.testing.assert_allclose(cmd.vx, g["vx"], atol=1e-5)
    np.testing.assert_allclose(cmd.wz, g["wz"], atol=1e-5)
    np.testing.assert_allclose(cmd.costs, g["costs"], rtol=1e-5, atol=1e-5)


def test_port_never_imports_jax():
    """Both entry points run with nothing of JAX (nor flax, nor optax) and
    nothing of the JAX package loaded: no such module in ``sys.modules``,
    and no loaded module's file under ``dddmr_navigation_tpu/``."""
    code = ("import os, sys\n"
            "import dddmr_navigation_tpu_torch\n"
            "import dddmr_navigation_tpu_torch.entry\n"
            "import dddmr_navigation_tpu_torch.interop\n"
            "import dddmr_navigation_tpu_torch.config\n"
            "import dddmr_navigation_tpu_torch.io\n"
            "import dddmr_navigation_tpu_torch.utils\n"
            "import dddmr_navigation_tpu_torch.ops.build\n"
            "import dddmr_navigation_tpu_torch.parallel.fleet\n"
            "import dddmr_navigation_tpu_torch.control.fused\n"
            "import dddmr_navigation_tpu_torch.perception.marking\n"
            "import dddmr_navigation_tpu_torch.perception.layers\n"
            "import dddmr_navigation_tpu_torch.perception.static_weights\n"
            "import dddmr_navigation_tpu_torch.planning.global_.graph\n"
            "import dddmr_navigation_tpu_torch.planning.global_.planner\n"
            "import dddmr_navigation_tpu_torch.ops.compaction\n"
            "import dddmr_navigation_tpu_torch.control.fsm\n"
            "import dddmr_navigation_tpu_torch.control.recovery\n"
            "import dddmr_navigation_tpu_torch.state_estimation.pf\n"
            "import dddmr_navigation_tpu_torch.state_estimation.likelihood\n"
            "import dddmr_navigation_tpu_torch.state_estimation.mcl\n"
            "import dddmr_navigation_tpu_torch.perception.depth_camera\n"
            "import dddmr_navigation_tpu_torch.perception.stitcher\n"
            "import dddmr_navigation_tpu_torch.runtime.watchdog\n"
            "import dddmr_navigation_tpu_torch.planning.global_.runtime\n"
            "import dddmr_navigation_tpu_torch.planning.global_.dwa\n"
            "import dddmr_navigation_tpu_torch.control.plan_manager\n"
            "import dddmr_navigation_tpu_torch.control.move_base\n"
            "import dddmr_navigation_tpu_torch.control.session\n"
            "import dddmr_navigation_tpu_torch.io.pcd\n"
            "import dddmr_navigation_tpu_torch.state_estimation.submaps\n"
            "import dddmr_navigation_tpu_torch.state_estimation.odom3d\n"
            "import dddmr_navigation_tpu_torch.state_estimation"
            ".feature_weights\n"
            "import dddmr_navigation_tpu_torch.state_estimation"
            ".global_localization\n"
            "import dddmr_navigation_tpu_torch.parallel.multihost\n"
            "import dddmr_navigation_tpu_torch.io.occupancy\n"
            "import dddmr_navigation_tpu_torch.slam\n"
            "import dddmr_navigation_tpu_torch.slam.projection\n"
            "import dddmr_navigation_tpu_torch.slam.features\n"
            "import dddmr_navigation_tpu_torch.slam.scan_matching\n"
            "import dddmr_navigation_tpu_torch.slam.pose_graph\n"
            "import dddmr_navigation_tpu_torch.slam.pipeline\n"
            "import dddmr_navigation_tpu_torch.slam.editor\n"
            "import dddmr_navigation_tpu_torch.perception.semantic\n"
            "import dddmr_navigation_tpu_torch.perception.semantic_data\n"
            "import dddmr_navigation_tpu_torch.perception.semantic_scene19\n"
            "import dddmr_navigation_tpu_torch.runtime\n"
            "import dddmr_navigation_tpu_torch.runtime.actions\n"
            "import dddmr_navigation_tpu_torch.runtime.checkpoint\n"
            "import dddmr_navigation_tpu_torch.runtime.tracing\n"
            "import dddmr_navigation_tpu_torch.runtime.viewer\n"
            "import dddmr_navigation_tpu_torch.runtime.viewer3d\n"
            "import dddmr_navigation_tpu_torch.io.rosbag\n"
            "import dddmr_navigation_tpu_torch.io.native\n"
            "fn, args = dddmr_navigation_tpu_torch.entry.entry('cpu')\n"
            "fn(*args)\n"
            "from dddmr_navigation_tpu_torch import entry as e\n"
            "cfg = e.config3_config(3, 3, 8, 32, 16, 8, 64, 128, 16)\n"
            "c3 = e.config3_inputs(cfg, 'cpu', resolution=1.0)\n"
            "pts, m = e.config3_scan(cfg, e.config3_world(), c3.robot, 0.0)\n"
            "import torch\n"
            "r = torch.as_tensor(c3.robot)[None]\n"
            "c3.tick(c3.fmap, e.config3_state(c3), torch.as_tensor(pts)[None],\n"
            "        torch.as_tensor(m)[None], r, torch.tensor([[0., 0, 0, 1]]),\n"
            "        torch.as_tensor(c3.offset), torch.as_tensor(c3.goal)[None],\n"
            "        torch.zeros(1), torch.zeros(1))\n"
            "from dddmr_navigation_tpu_torch.state_estimation import mcl, pf\n"
            "c4 = e.config4_inputs(e.config4_config(3, 3, 8, 32, 16, 256, 32,\n"
            "                                       16, 128, 512, 64, 8),\n"
            "                      e.config4_world(2, 256), 'cpu')\n"
            "gen = torch.Generator().manual_seed(0)\n"
            "st = e.config4_state(c4, mcl.init_draws(gen, c4.mcl, 2, 'cpu'))\n"
            "out, _ = e.run_fleet_full_chain(\n"
            "    c4, st, lambda t: pf.draw_mcl(gen, 2, 8, 'cpu'), 2)\n"
            "assert out['decision'].shape == (2, 2)\n"
            "sc = e.session_scenario(e.session_config(8, 90, 16, 8, 1, 2, 8),\n"
            "                        size=(4.0, 3.0), room_half=2.5,\n"
            "                        start=(-1.5, 0, 0), goal=(1.5, 0, 0),\n"
            "                        wall=((-0.1, -0.4, 0), (0.1, 0.4, 1)),\n"
            "                        no_entry=(-0.3, 0.3, 0.6, 1.2),\n"
            "                        depth_points=32, scan_rings=8,\n"
            "                        scan_cols=60)\n"
            "ch = e.run_session_chain(e.make_session(sc, 'cpu'), sc, 2)\n"
            "assert len(ch.vx) == 2\n"
            "gsc = e.global_localization_scenario(64, 1, 3)\n"
            "gl = e.make_global_localization(\n"
            "    gsc, torch.Generator().manual_seed(0), device='cpu')\n"
            "assert len(e.run_global_localization(gsc, gl).n) == 2\n"
            "from dddmr_navigation_tpu_torch.config import SlamConfig\n"
            "ssc = e.slam_scenario(SlamConfig(num_horizontal_scans=120,\n"
            "                                 max_less_flat=256,\n"
            "                                 max_keyframes=8, max_edges=8,\n"
            "                                 scan_match_iters=2,\n"
            "                                 map_match_iters=2), 2)\n"
            "mc = e.run_mapping_chain(e.make_mapping_session(ssc, 'cpu'), ssc)\n"
            "assert len(mc.keyframes) == 2\n"
            "r = e.run_semantic_reroute('cpu')\n"
            "assert r['ok_zone'] and len(r['zone']) > 50\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m in ('flax', 'optax')\n"
            "             or m.startswith(('flax.', 'optax.'))\n"
            "             or m == 'dddmr_navigation_tpu'\n"
            "             or m.startswith('dddmr_navigation_tpu.'))\n"
            "assert not bad, bad\n"
            "jax_pkg = os.path.join(sys.argv[1], 'dddmr_navigation_tpu') + os.sep\n"
            "files = sorted(f for f in (getattr(m, '__file__', None)\n"
            "                           for m in list(sys.modules.values()))\n"
            "               if f and os.path.abspath(f).startswith(jax_pkg))\n"
            "assert not files, files\n")
    proc = subprocess.run([sys.executable, "-c", code, ROOT], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_cuda():
    """Called without ``device``, every entry point targets the card: with
    one, its tensors lie there; without one, the call raises and returns
    no CPU tensors."""
    from dddmr_navigation_tpu_torch.control.fused import build_fused_map
    from dddmr_navigation_tpu_torch.io import flat_ground_map
    from dddmr_navigation_tpu_torch.perception.static_map import (
        build_map_context)
    from dddmr_navigation_tpu_torch.planning.global_.runtime import (
        GlobalPlannerRuntime)
    from dddmr_navigation_tpu_torch.config import MCLConfig
    from dddmr_navigation_tpu_torch.state_estimation.odom3d import (
        init_odom3d)
    from dddmr_navigation_tpu_torch.state_estimation.submaps import (
        PoseGraph, SubmapManager)
    from dddmr_navigation_tpu_torch.perception.semantic import init_segmenter
    cfg = entry.headline_config(4, 4, 8, 16, 8, 8, 32)
    c3_cfg = entry.config3_config(3, 3, 8, 32, 16, 8, 64, 128, 16)
    ground = flat_ground_map(2, 2, 0.5)
    calls = {
        "entry": lambda: entry.entry()[1][0].positions,
        "headline_inputs": lambda: entry.headline_inputs(cfg, 2)[2],
        "config3_inputs": lambda: entry.config3_inputs(
            c3_cfg, map_data=(ground, ground[:1], np.ones(len(ground)),
                              np.full(len(ground), 9999.0))).fmap.ground,
        "build_fused_map": lambda: build_fused_map(c3_cfg, ground).ground,
        "build_map_context": lambda: build_map_context(ground).ground,
        "make_global_plan": lambda: make_global_plan(
            np.zeros((1, 4, 3)), max_len=8).positions,
        "make_session": lambda: entry.make_session(entry.session_scenario(
            entry.session_config(8, 90, 16, 8, 1, 2, 8), size=(2.0, 2.0),
            depth_points=8)).composed_dgraph,
        "GlobalPlannerRuntime": lambda: GlobalPlannerRuntime(
            entry.session_config(), ground).ground_dev,
        "init_odom3d": lambda: init_odom3d().pos,
        "make_global_localization": lambda: entry.make_global_localization(
            entry.global_localization_scenario(64, 1, 2),
            torch.Generator()).state.particles.pos,
        "SubmapManager": lambda: SubmapManager(
            PoseGraph(np.zeros((1, 8), np.float32), [ground], [ground]),
            MCLConfig()).initialize([0.0, 0.0, 0.0]).ground_normal,
        "make_mapping_session": lambda: entry.make_mapping_session(
            ).graph.pos,
        "init_segmenter": lambda: init_segmenter(32, 32, 3, 8)[1][
            "Conv_0.bias"],
        "load_segmenter": lambda: entry.load_segmenter()[1]["Conv_0.bias"],
        "semantic_scenario": lambda: entry.semantic_scenario(1).params[
            "Conv_0.bias"],
        "run_semantic_reroute": lambda: torch.as_tensor(
            entry.run_semantic_reroute()["field"]),
    }
    have_card = torch.cuda.is_available()
    for name, call in calls.items():
        if have_card:
            assert call().device.type == "cuda", name
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                call()


# ---------------------------------------------------------------------------
# the omni and rotate generators, heading predicates, collision_min_max
# (the JAX package's test_rotate_samples, test_omni_*, test_goal_reached_
# and_heading and test_collision_min_max_* cases, held against JAX)
# ---------------------------------------------------------------------------

OMNI_CFG = LocalPlannerConfig()


def test_rotate_samples_match_jax():
    from dddmr_navigation_tpu.planning.local.sampler import (
        rotate_inplace_samples as j_rot)
    from dddmr_navigation_tpu_torch.planning.local.sampler import (
        rotate_inplace_samples)
    cfg = config_from(OMNI_CFG)
    want, wvalid = j_rot(OMNI_CFG.rotate_generator, OMNI_CFG.generator.limits)
    got, valid = rotate_inplace_samples(cfg.rotate_generator,
                                        cfg.generator.limits, 3, "cpu")
    assert got.shape == (3, 2, 2)
    for b in range(3):
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(wvalid))
    np.testing.assert_allclose(got[0][valid[0]].numpy(),
                               [[0.0, 0.5], [0.0, -0.5]], atol=1e-6)


OMNI_STATES = [(0.0, 0.0, 0.0), (0.43, -0.21, 0.13), (1.0, 0.5, -0.31),
               (-0.3, 0.0, 0.5)]


def test_omni_samples_match_jax():
    from dddmr_navigation_tpu.planning.local.sampler import (
        omni_simple_samples as j_omni)
    from dddmr_navigation_tpu_torch.planning.local.sampler import (
        omni_simple_samples)
    v, vy, w = (np.asarray(c, np.float32) for c in zip(*OMNI_STATES))
    want, wmask = jax.jit(jax.vmap(lambda *a: j_omni(
        OMNI_CFG.omni_generator, *a)))(v, vy, w)
    got, mask = omni_simple_samples(config_from(OMNI_CFG).omni_generator,
                                    *(tensor(x, "cpu") for x in (v, vy, w)))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(wmask))
    # the omni windows' bounds may round an ulp apart from XLA's
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert mask.sum() > 100


def _gen_rollouts(gen_name, b=3):
    """JAX's and the port's rollouts of the omni or rotate generator for
    ``b`` robots at seeded poses."""
    from dddmr_navigation_tpu.planning.local import sampler as js
    from dddmr_navigation_tpu_torch.planning.local import sampler as ts
    rng = np.random.default_rng(11)
    pos = rng.uniform(-1, 1, (b, 3)).astype(np.float32)
    pos[:, 2] = rng.uniform(0, 0.2, b)
    quat = np.asarray(jgeo.quat_from_rpy(
        *(rng.uniform(-a, a, b).astype(np.float32) for a in (0.05, 0.1, 3))))
    v, vy, w = (rng.uniform(-0.4, 0.6, b).astype(np.float32)
                for _ in range(3))
    cfg, tcfg = OMNI_CFG, config_from(OMNI_CFG)
    if gen_name == "omni":
        gen, tgen = cfg.omni_generator, tcfg.omni_generator
        lim = gen.limits
        kw = dict(sim_time=gen.sim_time, min_vel_x=lim.min_vel_trans,
                  min_vel_theta=lim.min_vel_theta,
                  max_vel_x=lim.max_vel_trans)

        def j_samples(v, vy, w):
            return js.omni_simple_samples(gen, v, vy, w)
        t_samples = ts.omni_simple_samples(tgen, *(tensor(x, "cpu")
                                                   for x in (v, vy, w)))
    else:
        gen, tgen = cfg.rotate_generator, tcfg.rotate_generator
        kw = dict(sim_time=0.0, min_vel_x=-1.0, min_vel_theta=-1.0,
                  max_vel_x=-1.0)

        def j_samples(v, vy, w):
            return js.rotate_inplace_samples(gen, cfg.generator.limits)
        t_samples = ts.rotate_inplace_samples(tgen, tcfg.generator.limits, b,
                                              "cpu")
    kw.update(sim_granularity=gen.sim_granularity,
              angular_sim_granularity=gen.angular_sim_granularity,
              max_steps=gen.max_num_steps)

    def one(p, q, v, vy, w):
        s, ok = j_samples(v, vy, w)
        sim_t = (None if gen_name == "omni" else
                 6.28 / jnp.maximum(jnp.abs(s[:, -1]), 1e-6))
        return j_rollout(s, ok, p, q, sim_time_per_sample=sim_t, **kw)
    want = jax.jit(jax.vmap(one))(pos, quat, v, vy, w)
    s, ok = t_samples
    sim_t = (None if gen_name == "omni" else
             6.28 / torch.clamp(torch.abs(s[..., -1]), min=1e-6))
    got = rollout(s, ok, tensor(pos, "cpu"), tensor(quat, "cpu"),
                  sim_time_per_sample=sim_t, **kw)
    return jax.tree_util.tree_map(np.asarray, want), to_numpy(got)


@pytest.mark.parametrize("gen_name", ["omni", "rotate"])
def test_generator_rollouts_match_jax(gen_name):
    want, got = _gen_rollouts(gen_name)
    np.testing.assert_array_equal(got.num_steps, want.num_steps)
    np.testing.assert_array_equal(got.valid, want.valid)
    np.testing.assert_array_equal(got.step_valid, want.step_valid)
    np.testing.assert_allclose(got.dt, want.dt, rtol=1e-6)
    np.testing.assert_allclose(got.theta, want.theta, atol=1e-6)
    np.testing.assert_allclose(got.positions, want.positions, atol=1e-5)
    if gen_name == "rotate":     # a full revolution at 0.025 rad a step
        assert (got.num_steps == 252).all()


def test_heading_deviations_match_jax():
    from dddmr_navigation_tpu.planning.local.planner import (
        initial_heading_deviation as j_init, goal_heading_deviation as j_goal,
        shortest_angle_to_pose_heading as j_short)
    from dddmr_navigation_tpu_torch.planning.local.planner import (
        initial_heading_deviation, goal_heading_deviation,
        shortest_angle_to_pose_heading)
    plans, pos, *_ = small_inputs()
    plans[2, :, 1] = 0.0               # a straight line along x
    b = len(plans)
    yaws = np.asarray([0.0, 2.0, -0.4, 3.0], np.float32)
    quat = np.asarray(jgeo.quat_from_yaw(yaws))
    pos = pos.copy()
    pos[2] = [0.0, 0.0, 0.0]
    jplans = stack_plans([j_make_plan(p, max_len=64) for p in plans])
    cfg = SMALL

    def one(plan, p, q):
        return (*j_init(cfg, plan, p, q), *j_goal(cfg, plan, q),
                j_short(q, plan.quats[5]))
    want = [np.asarray(x) for x in jax.jit(jax.vmap(one))(jplans, pos, quat)]
    tplan = to_port(jax.tree_util.tree_map(np.asarray, jplans), GlobalPlan,
                    "cpu")
    tpos, tquat = tensor(pos, "cpu"), tensor(quat, "cpu")
    got = [x.numpy() for x in (
        *initial_heading_deviation(cfg, tplan, tpos, tquat),
        *goal_heading_deviation(cfg, tplan, tquat),
        shortest_angle_to_pose_heading(tquat, tplan.quats[:, 5]))]
    for i in (1, 2, 4):                                  # the bools
        np.testing.assert_array_equal(got[i], want[i])
    for i in (0, 3, 5):                                  # the yaws
        np.testing.assert_allclose(got[i], want[i], atol=1e-6)
    # the JAX package's own cases: aligned along a straight plan, and 2 rad
    # off it
    assert got[1][2] and got[2][2]
    assert not got[1][1] and got[2][1]


def _min_max_case():
    """A 3-robot batch for collision_min_max: a wall ahead, distant
    points, and four points (under the critic's 5-point gate)."""
    gen = LocalPlannerConfig().generator
    wall = [[0.5, y, 0.3] for y in np.arange(-0.5, 0.51, 0.1)]
    far = [[50.0 + i, 50.0, 0.3] for i in range(10)]
    obs = np.zeros((3, 16, 3), np.float32)
    mask = np.zeros((3, 16), bool)
    for b, pts in enumerate((wall, far, [[0.5, 0.0, 0.3]] * 4)):
        obs[b, :len(pts)] = pts
        mask[b, :len(pts)] = True
    return gen, obs, mask


def test_collision_min_max_matches_jax():
    gen, obs, mask = _min_max_case()
    v = np.full(3, 0.3, np.float32)
    zeros = np.zeros(3, np.float32)
    ident = np.tile(np.float32([[0, 0, 0, 1]]), (3, 1))
    pos = np.zeros((3, 3), np.float32)
    kw = dict(sim_time=gen.sim_time, sim_granularity=gen.sim_granularity,
              angular_sim_granularity=gen.angular_sim_granularity,
              min_vel_x=gen.limits.min_vel_x,
              min_vel_theta=gen.limits.min_vel_theta,
              max_vel_x=gen.limits.max_vel_x, max_steps=gen.max_num_steps)

    def one(p, q, v, w, o, m):
        s, ok = j_dd_samples(gen, v, w, jnp.float32(-1.0))
        r = j_rollout(s, ok, p, q, **kw)
        return jcrit.collision_min_max_scores(r, gen.cuboid, o, m), r.samples
    want, samples = jax.jit(jax.vmap(one))(pos, ident, v, zeros, obs, mask)
    tgen = config_from(gen)
    s, ok = dd_simple_samples(tgen, tensor(v, "cpu"), tensor(zeros, "cpu"),
                              torch.full((3,), -1.0))
    r = rollout(s, ok, tensor(pos, "cpu"), tensor(ident, "cpu"), **kw)
    got = tcrit.collision_min_max_scores(r, tgen.cuboid, tensor(obs, "cpu"),
                                         tensor(mask, "cpu")).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    samples = np.asarray(samples)
    fwd = (r.valid.numpy()[0] & (samples[0, :, 0] > 0.2)
           & (np.abs(samples[0, :, -1]) < 0.1))
    assert fwd.any() and (got[0][fwd] == -1.0).all()   # the wall rejects
    assert (got[1] == 0.0).all() and (got[2] == 0.0).all()


def _generator_ticks(generator, critics=None):
    """One tick of the small fleet plus a wall-ahead robot through
    ``generator`` (and the given critic stack), JAX's and the port's."""
    from dddmr_navigation_tpu.config import (
        CriticsConfig as JCritics, CriticConfig as JCritic)
    plans, pos, yaw, v, w, obs, obs_valid, cap, hd = small_inputs(b=4, m=64)
    # robot 0 faces a wall dead ahead with free space to its sides
    wall = np.asarray([[0.8, y, 0.25] for y in np.arange(-1.0, 1.01, 0.05)],
                      np.float32)
    obs[0] = pos[0] + np.pad(wall, ((0, 64 - len(wall)), (0, 0)),
                             mode="edge")
    obs_valid[0] = True
    yaw[0] = 0.0
    # off the vy lattice's zero (a multiple of 0.1 puts a sample at zero,
    # where XLA's rounding of the window may differ by context)
    vy = np.asarray([0.03, 0.23, -0.13, 0.05], np.float32)
    cfg = SMALL
    if critics == "min_max":
        cfg = LocalPlannerConfig(**{
            **{f: getattr(SMALL, f) for f in SMALL.__dataclass_fields__},
            "critics": JCritics(collision=None, collision_min_max=JCritic(
                plugin="mpc_critics::CollisionMinMaxModel", weight=1.0))})
        cfg = config_from(cfg)
    quat = np.asarray(jgeo.quat_from_yaw(yaw))
    jplans = stack_plans([j_make_plan(p, max_len=cfg.max_plan_len)
                          for p in plans])

    def one(plan, p, q, v, w, o, m, c, h, vy):
        return j_tick(cfg, plan, p, q, v, w, o, m, c, h, generator=generator,
                      vy_now=vy)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(one))(
        jplans, pos, quat, v, w, obs, obs_valid, cap, hd, vy))
    tplan = to_port(jax.tree_util.tree_map(np.asarray, jplans), GlobalPlan,
                    "cpu")
    got = to_numpy(compute_velocity_command(
        cfg, tplan, *(tensor(x, "cpu") for x in (
            pos, quat, v, w, obs, obs_valid, cap, hd)),
        generator=generator, vy_now=tensor(vy, "cpu")))
    return want, got


@pytest.mark.parametrize("generator,critics", [
    ("omni_drive_simple", None),
    ("differential_drive_rotate_inplace", None),
    ("differential_drive_rotate_shortest_angle", None),
    ("differential_drive_simple", "min_max")])
def test_generator_ticks_match_jax(generator, critics):
    want, got = _generator_ticks(generator, critics)
    np.testing.assert_array_equal(got.rejected, want.rejected)
    np.testing.assert_allclose(got.costs, want.costs, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.state, want.state)
    assert_best_index(got.best_index, want.best_index, want.costs)
    for f in ("vx", "wz", "vy"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   atol=1e-5, err_msg=f)
    if generator == "omni_drive_simple":
        # the JAX package's lateral-dodge case: the wall-facing robot keeps
        # a collision-free command, and vy is a real output
        assert got.state[0] in (PlannerState.TRAJECTORY_FOUND,
                                PlannerState.ALL_TRAJECTORIES_FAIL)
        if got.state[0] == PlannerState.TRAJECTORY_FOUND:
            assert got.best_cost[0] >= 0.0
        assert (got.vy != 0).any()
    if critics == "min_max":
        assert got.rejected[0].any()
