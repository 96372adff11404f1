"""The port's full-fidelity fleet tick (bench config 4) against the JAX
package, on the CPU: the fleet relaxations and extractions on random
graphs, the fleet's plan finish and interpolation, the MCL feature
clouds, the whole tick chained at ``tests/test_fleet_full.py``'s world
(B = 3, N_PAD 512, robot 1 boxed in so that the rotate generator, the
recovery and the FSM's recovery branch fire), and bench config 4 at full
width against ``testdata/config4_golden.npz``.

Tolerances: exact for decisions, command sources, planner states, masks,
node ids, counts and iterations, and for the relaxed fields; 1e-5 for
commands, plan positions and MCL poses; 1e-6 for feature points.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from functools import partial

from dddmr_navigation_tpu.config import (
    NavigationConfig, LocalPlannerConfig, DDSimpleGeneratorConfig,
    PerceptionConfig, SpinningLidarConfig, GlobalPlannerConfig,
    MoveBaseConfig, MCLConfig)
from dddmr_navigation_tpu.geometry import quat_from_yaw as j_quat_from_yaw
from dddmr_navigation_tpu.io.maps import flat_ground_map, box_obstacle
from dddmr_navigation_tpu.control import fused as jfused
from dddmr_navigation_tpu.parallel import fleet as jfleet
from dddmr_navigation_tpu.planning.global_ import planner as jplanner
from dddmr_navigation_tpu.planning.global_ import wavefront as jwf
from dddmr_navigation_tpu.state_estimation.likelihood import (
    build_submap_context)

from dddmr_navigation_tpu_torch import entry
from dddmr_navigation_tpu_torch.control import fused as tfused
from dddmr_navigation_tpu_torch.interop import (
    DRAW_KEYS, config_from, fleet_full_state_from, port_draws, port_mcl_state,
    tensor, to_numpy)
from dddmr_navigation_tpu_torch.parallel import fleet as tfleet
from dddmr_navigation_tpu_torch.planning.global_ import planner as tplanner
from dddmr_navigation_tpu_torch.planning.global_ import wavefront as twf
from dddmr_navigation_tpu_torch.state_estimation import mcl as tmcl
from dddmr_navigation_tpu_torch.state_estimation import pf as tpf

from tools.make_config4_golden import jax_mcl_draws

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                      "config4_golden.npz")


def t(x):
    return tensor(x, "cpu")


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# the fleet's relaxations and extractions on a random graph
# ---------------------------------------------------------------------------

G, K, R, BINS = 300, 8, 5, 16


@pytest.fixture(scope="module")
def graph():
    """A kNN graph over random points, per-robot edge validity, entry
    costs with lethal nodes, goals and starts, and the turning tables."""
    rng = np.random.default_rng(1)
    pos2 = rng.uniform(0, 10, (G, 2))
    d2 = ((pos2[:, None] - pos2[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbr = np.argsort(d2, 1)[:, :K].astype(np.int32)
    nd = np.sqrt(np.take_along_axis(d2, nbr, 1)).astype(np.float32)
    valid = np.broadcast_to(nd < 1.5, (R, G, K)).copy()
    valid[rng.random((R, G, K)) < 0.05] = False
    enter = rng.exponential(0.3, (R, G)).astype(np.float32)
    enter[rng.random((R, G)) < 0.08] = np.inf
    enter2 = (enter * rng.uniform(0.9, 1.2, enter.shape)).astype(np.float32)
    intens = rng.exponential(0.1, G).astype(np.float32)
    goals = rng.integers(0, G, R).astype(np.int32)
    starts = rng.integers(0, G, R).astype(np.int32)
    positions = np.concatenate([pos2, np.zeros((G, 1))], 1).astype(np.float32)
    az = np.asarray(jwf.edge_azimuth(positions, nbr))
    bins = np.mod(np.floor((az + np.pi) / (2 * np.pi) * BINS).astype(np.int32),
                  BINS)
    turn_pen = np.asarray(jwf.turning_penalty_table(nbr, positions, 0.1))
    return dict(nbr=nbr, nd=nd, valid=valid, enter=enter, enter2=enter2,
                intens=intens, goals=goals, starts=starts,
                positions=positions, az=az, bins=bins, turn_pen=turn_pen)


def _relax_both(g, turning, warm):
    """JAX's fleet relaxation and the port's, cold from +inf or warm from
    the cold field with risen entry costs."""
    kw = dict(max_iters=512)
    if turning:
        jfn = partial(jwf.fleet_wavefront_distances_turning,
                      turning_weight=0.1, az=g["az"], bin_of_edge=g["bins"],
                      n_dir_bins=BINS, **kw)
        tfn = partial(twf.fleet_wavefront_distances_turning,
                      turning_weight=0.1, az=t(g["az"]),
                      bin_of_edge=t(g["bins"]), n_dir_bins=BINS, **kw)
    else:
        jfn = partial(jwf.fleet_wavefront_distances, **kw)
        tfn = partial(twf.fleet_wavefront_distances, **kw)
    args = (g["nbr"], g["nd"], g["valid"], g["enter"], g["intens"],
            g["goals"])
    want = jax.jit(jfn)(*args)
    got = tfn(*(t(a) for a in args))
    if warm:
        args = args[:3] + (g["enter2"],) + args[4:]
        want = jax.jit(jfn)(*args, dist0_r=want[0])
        got = tfn(*(t(a) for a in args), dist0_r=got[0])
    return as_np(want), to_numpy(got)


@pytest.mark.parametrize("turning", [True, False], ids=["turning", "plain"])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_fleet_relaxation_matches_jax(graph, turning, warm):
    (wd, wi), (gd, gi) = _relax_both(graph, turning, warm)
    np.testing.assert_array_equal(gd, wd)
    assert int(gi) == int(wi) and np.ndim(gi) == 0
    assert np.isfinite(wd).sum() > 0.5 * wd.size
    if not turning:      # finite dist at lethal nodes (the F-space finish)
        assert np.isfinite(gd[graph["enter"] == np.inf]).any()


def test_fleet_turning_field_is_the_batched_field(graph):
    """The port runs the fleet relaxation as the robot-batched one: the
    field is the per-robot relaxation's bit for bit, and the shared count
    is the largest per-robot count."""
    g = graph
    args = [t(a) for a in (g["nbr"], g["nd"], g["valid"], g["enter"],
                           g["intens"], g["goals"])]
    fleet, iters = twf.fleet_wavefront_distances_turning(
        *args, 0.1, az=t(g["az"]), bin_of_edge=t(g["bins"]),
        n_dir_bins=BINS, max_iters=512)
    per, _, per_iters = twf.wavefront_distances_turning(
        *args, t(g["positions"]), 0.1, n_dir_bins=BINS, max_iters=512,
        az=t(g["az"]), bin_of_edge=t(g["bins"]))
    assert torch.equal(fleet, per)
    assert int(iters) == int(per_iters.max()) > int(per_iters.min())


@pytest.mark.parametrize("turning", [True, False], ids=["turning", "plain"])
def test_fleet_extraction_matches_jax(graph, turning):
    g = graph
    (wd, _), _ = _relax_both(g, turning, False)
    common = (g["nbr"], g["nd"], g["valid"], g["enter"], wd)
    if turning:
        want = jax.jit(partial(jwf.fleet_extract_path_turning, max_len=64))(
            *common, g["bins"], g["starts"], g["goals"], g["turn_pen"])
        got = twf.fleet_extract_path_turning(
            *(t(a) for a in common), t(g["bins"]), t(g["starts"]),
            t(g["goals"]), t(g["turn_pen"]), max_len=64)
    else:
        want = jax.jit(partial(jwf.fleet_extract_path, max_len=64))(
            *common, g["starts"], g["goals"])
        got = twf.fleet_extract_path(*(t(a) for a in common),
                                     t(g["starts"]), t(g["goals"]),
                                     max_len=64)
    for w, x, name in zip(as_np(want), to_numpy(got),
                          ("idxs", "valids", "length", "ok")):
        np.testing.assert_array_equal(x, w, err_msg=name)
    assert np.asarray(want[3]).any()


@pytest.mark.parametrize("stalled", [False, True])
def test_fleet_plan_finish_and_interpolation_match_jax(graph, stalled):
    """fleet_plan_finish (its shared count broadcast, and the carry reset
    when that count reached max_relax_iters) and the fleet interpolation."""
    g = graph
    (wd, wi), _ = _relax_both(g, True, False)
    gp = GlobalPlannerConfig(turning_weight=0.1, max_relax_iters=(
        int(wi) if stalled else 512), max_path_len=64)
    sg_ok = np.asarray([True, True, False, True, True])
    prep = jplanner.PlanPrep(
        start_idx=g["starts"], goal_idx=g["goals"], sg_ok=sg_ok,
        graph_valid=g["valid"], enter=g["enter"], warm_dist=None)

    def jfinish(d, it):
        res = jplanner.fleet_plan_finish(gp, g["nbr"], g["nd"],
                                         g["positions"], prep, d, it,
                                         turn_pen=g["turn_pen"],
                                         wf_bins=g["bins"])
        return res, jfused.fleet_interpolate_path_device(
            jnp.asarray(g["positions"]), res, max_plan_len=128)
    wres, wplan = as_np(jax.jit(jfinish)(wd, wi))
    tprep = tplanner.PlanPrep(*(t(x) for x in (
        g["starts"], g["goals"], sg_ok, g["valid"], g["enter"])), None)
    gres = tplanner.fleet_plan_finish(
        config_from(gp), t(g["nbr"]), t(g["nd"]), t(g["positions"]), tprep,
        t(wd), torch.tensor(int(wi), dtype=torch.int32),
        turn_pen=t(g["turn_pen"]), wf_bins=t(g["bins"]))
    gplan = tfused.fleet_interpolate_path_device(t(g["positions"]), gres,
                                                 max_plan_len=128)
    gres, gplan = to_numpy(gres), to_numpy(gplan)
    for f in ("node_ids", "node_valid", "length", "ok", "goal_idx", "iters"):
        np.testing.assert_array_equal(getattr(gres, f), getattr(wres, f),
                                      err_msg=f)
    np.testing.assert_array_equal(gres.dist_carry, wres.dist_carry)
    np.testing.assert_array_equal(gres.dist_to_goal, wres.dist_to_goal)
    assert np.isinf(gres.dist_carry).all() == stalled
    np.testing.assert_array_equal(gplan.valid, wplan.valid)
    np.testing.assert_array_equal(gplan.count, wplan.count)
    np.testing.assert_allclose(gplan.positions, wplan.positions, atol=1e-6)
    np.testing.assert_allclose(gplan.quats, wplan.quats, atol=1e-6)
    assert gplan.count[0] > 0 and gplan.count[2] == 0


# ---------------------------------------------------------------------------
# the fleet at tests/test_fleet_full.py's world
# ---------------------------------------------------------------------------

B, N_PAD, DT = 3, 512, 0.1


@pytest.fixture(scope="module")
def world():
    lidar = SpinningLidarConfig(
        scan_effective_positive_start=0.0, scan_effective_negative_start=0.0,
        max_scan_points=N_PAD)
    cfg = NavigationConfig(
        perception=PerceptionConfig(lidar=lidar, voxel_window_cells_xy=48,
                                    voxel_window_cells_z=20,
                                    max_marked_voxels=256),
        local_planner=LocalPlannerConfig(
            generator=DDSimpleGeneratorConfig(
                linear_x_sample=5, angular_z_sample=5, max_num_steps=30),
            max_obstacle_points=256, collision_obstacle_chunk=16,
            collision_near_k=64),
        global_planner=GlobalPlannerConfig(
            turning_weight=0.1, max_long_edges=64, los_samples=8,
            max_lethal_points=256, max_relax_iters=128))
    mb = MoveBaseConfig(planner_patience=1.0, controller_patience=0.6,
                        oscillation_patience=0.0, waiting_patience=0.5,
                        no_plan_retry_num=1)
    mcl = MCLConfig(num_particles=48, init_var_x=0.3, init_var_y=0.3,
                    init_var_z=0.1, init_var_yaw=0.1, field_sampling="corr")
    ground = flat_ground_map(10, 8, 0.25)
    walls = np.concatenate([
        box_obstacle([-4.6, 0.0, 0.0], size=(0.3, 7.4, 1.2), resolution=0.15),
        box_obstacle([4.6, 0.0, 0.0], size=(0.3, 7.4, 1.2), resolution=0.15),
        box_obstacle([0.0, -3.6, 0.0], size=(9.0, 0.3, 1.2), resolution=0.15),
        box_obstacle([0.0, 3.6, 0.0], size=(9.0, 0.3, 1.2), resolution=0.15),
    ]).astype(np.float32)
    positions = np.stack([[-3.5, -1.0 + i, 0.0] for i in range(B)]
                         ).astype(np.float32)
    quats = np.tile(np.float32([[0.0, 0.0, 0.0, 1.0]]), (B, 1))
    goals = positions + np.array([6.5, 0.5, 0.0], np.float32)
    scans = np.zeros((B, N_PAD, 3), np.float32)
    masks = np.zeros((B, N_PAD), bool)
    for i in range(B):
        if i == 1:       # a tight ring all around: everything collides
            ang = np.linspace(-np.pi, np.pi, 96, endpoint=False)
            ring = np.stack([0.45 * np.cos(ang), 0.45 * np.sin(ang),
                             np.full_like(ang, 0.1)], 1)
            pts = np.concatenate([ring, ring + [0, 0, 0.25]])
        else:
            pts = (box_obstacle([1.2, 0.8, 0.0], size=(0.2, 0.2, 0.8),
                                resolution=0.1) - np.array([0, 0, 0.3]))
        scans[i, :len(pts)] = pts[:N_PAD]
        masks[i, :min(len(pts), N_PAD)] = True
    jmap = jfused.build_fused_map(cfg, ground, walls)
    jsub = build_submap_context(walls, ground, mcl)
    _, spec, ri, params = jfused.make_fused_tick(cfg)
    w = entry.Config4World(ground, walls, positions, quats, goals, scans,
                           masks)
    c4 = entry.config4_inputs((config_from(cfg), config_from(mb),
                               config_from(mcl)), w, device="cpu")
    return dict(cfg=cfg, mb=mb, mcl=mcl, w=w, jmap=jmap, jsub=jsub,
                spec=spec, ri=ri, params=params, c4=c4)


def test_device_features_match_jax(world):
    """The MCL feature clouds: the in-radius points in Knuth-hash order
    (the points out of reach share one key and go to the lower index, as
    lax.top_k orders them), in each robot's base frame."""
    w = world["w"]
    rng = np.random.default_rng(4)
    pos = np.stack([rng.uniform(-4, 4, 6), rng.uniform(-3, 3, 6),
                    np.zeros(6)], 1).astype(np.float32)
    quat = np.asarray(j_quat_from_yaw(rng.uniform(-3, 3, 6).astype(
        np.float32)))
    pos[0] = [-4.3, -3.3, 0.0]           # a corner
    want = jax.jit(jax.vmap(lambda p, q: jfleet.device_features_from_map(
        jnp.asarray(w.walls), jnp.asarray(w.ground), p, q)))(pos, quat)
    got = tfleet.device_features_from_map(t(w.walls), t(w.ground), t(pos),
                                          t(quat))
    for x, y, name in zip(to_numpy(got), as_np(want),
                          ("flat", "flat_ok", "sharp", "sharp_ok")):
        np.testing.assert_allclose(x, y, atol=1e-6, err_msg=name)
    flat, flat_ok, sharp, sharp_ok = to_numpy(got)
    # the warehouse fills both budgets from within the 8 m radius
    assert flat_ok.all() and sharp_ok.all()
    assert np.linalg.norm(sharp, axis=-1).max() <= 8.0 + 1e-5


TICKS = 12


@pytest.fixture(scope="module")
def chain(world):
    """The jitted JAX fleet tick and the port's, chained from one state
    with JAX's MCL draws, robot 1 boxed in; per-tick diagnostics."""
    cfg, mb, mcl = world["cfg"], world["mb"], world["mcl"]
    w, c4 = world["w"], world["c4"]
    state = jfleet.init_fleet_full_state(cfg, len(w.ground), w.positions,
                                         w.quats, localize=True, mcl_cfg=mcl)
    tick = jax.jit(partial(jfleet.fleet_full_tick, cfg, mb, world["spec"],
                           world["ri"], world["params"], mcl_cfg=mcl))
    pstate = fleet_full_state_from(as_np(state), "cpu")
    spec, ri, params = c4.specs
    drift_dir = np.tile(np.float32([[0.7, 0.7, 0.0]]), (B, 1))
    want, got = [], []
    for k in range(TICKS):
        d = jax_mcl_draws(state.mcl.key, mcl.num_particles)
        drift = (np.float32(0.025) * np.float32(k)) * drift_dir
        now = np.float32(k) * np.float32(DT)
        state, diag = tick(
            world["jmap"], state, w.scans, w.masks,
            jnp.asarray([0.0, 0.0, 0.3]), w.goals, jnp.float32(now),
            jnp.float32(DT), submap_ctx=world["jsub"],
            odom_drift_pos=jnp.asarray(drift), odom_drift_yaw=jnp.zeros((B,)),
            feature_map_pts=jnp.asarray(w.walls),
            feature_ground_pts=jnp.asarray(w.ground))
        pstate, pdiag = tfleet.fleet_full_tick(
            c4.cfg, c4.mb, spec, ri, params, c4.fmap, pstate, c4.scans,
            c4.masks, c4.offset, c4.goals, torch.tensor(now),
            torch.tensor(np.float32(DT)), mcl_cfg=c4.mcl,
            submap_ctx=c4.submap, odom_drift_pos=t(drift),
            odom_drift_yaw=torch.zeros(B), feature_map_pts=c4.walls,
            feature_ground_pts=c4.ground, mcl_draws=port_draws(d, "cpu"),
            feature_keys_=c4.keys)
        want.append(as_np(diag))
        got.append(to_numpy(pdiag))
    return want, got, as_np(state), pstate


INT_DIAG = ("decision", "cmd_source", "ps_simple", "ps_rotate", "plan_ok",
            "recovery_active", "recovery_succeed", "wf_iters",
            "init_aligned", "goal_aligned", "goal_reached", "plan_empty")
FLOAT_DIAG = ("vx", "wz", "v_achieved", "w_achieved", "plan_pos",
              "plan_yaw", "mcl_err", "match_ratio")


@pytest.mark.parametrize("kind", ["integers", "floats"])
def test_fleet_full_tick_matches_jax(chain, kind):
    want, got, _, _ = chain
    for k, (wd, gd) in enumerate(zip(want, got)):
        if kind == "integers":
            for f in INT_DIAG:
                np.testing.assert_array_equal(gd[f], wd[f],
                                              err_msg=f"tick {k} {f}")
        else:
            for f in FLOAT_DIAG:
                np.testing.assert_allclose(gd[f], wd[f], atol=1e-5,
                                           err_msg=f"tick {k} {f}")


def test_fleet_full_chain_state_matches_jax(chain):
    _, _, jstate, pstate = chain
    for f in ("pos", "quat", "v", "w", "odom_prev_pos"):
        np.testing.assert_allclose(getattr(pstate, f).numpy(),
                                   getattr(jstate, f), atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(pstate.fsm.decision.numpy(),
                                  jstate.fsm.decision)
    np.testing.assert_allclose(pstate.mcl.particles.pos.numpy(),
                               jstate.mcl.particles.pos, atol=1e-5)
    np.testing.assert_array_equal(pstate.fused.wf_goal_idx.numpy(),
                                  jstate.fused.wf_goal_idx)


def test_fleet_full_chain_exercises_recovery(chain):
    """Robot 1 (boxed in): every simple rollout collides, the controller
    patience runs out, a recovery is requested, the rotate-in-place
    recovery collides too and fails, and the FSM aborts; the free robots
    drive under the simple generator and turn under the rotate one."""
    _, got, _, _ = chain
    dec = np.stack([d["decision"] for d in got])
    assert (np.stack([d["ps_simple"] for d in got])[:, 1] == 2).all()
    assert (np.stack([d["ps_rotate"] for d in got])[:, 1] == 2).all()
    assert (dec[:, 1] == 7).any() and dec[-1, 1] == 9
    assert not np.stack([d["recovery_succeed"] for d in got])[:, 1].any()
    cmd = np.stack([d["cmd_source"] for d in got])
    assert (cmd[:, [0, 2]] == 1).any() and (cmd[:, [0, 2]] == 2).any()
    assert (dec[:, [0, 2]] == 4).any() and (dec[:, [0, 2]] != 9).all()
    assert (np.stack([d["vx"] for d in got])[:, [0, 2]] > 0.05).any()


def test_fused_fleet_tick_matches_jax(world):
    """The vmapped fused tick of a fleet (config 3's stages, no MCL)."""
    cfg, w, c4 = world["cfg"], world["w"], world["c4"]
    states = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *[
        jfused.init_fused_state(cfg, len(w.ground), robot_xyz=p)
        for p in w.positions])
    v = np.full(B, 0.2, np.float32)
    want = as_np(jax.jit(partial(jfleet.fused_fleet_tick, cfg, world["spec"],
                                 world["ri"], world["params"]))(
        world["jmap"], states, w.scans, w.masks, w.positions, w.quats,
        jnp.asarray([0.0, 0.0, 0.3]), w.goals, v, np.zeros(B, np.float32)))
    spec, ri, params = c4.specs
    got = to_numpy(tfleet.fused_fleet_tick(
        c4.cfg, spec, ri, params, c4.fmap,
        tfused.init_fused_state(c4.cfg, len(w.ground), t(w.positions)),
        c4.scans, c4.masks, t(w.positions), t(w.quats), c4.offset, c4.goals,
        t(v), torch.zeros(B)))
    np.testing.assert_array_equal(got[3], want[3])          # state codes
    np.testing.assert_array_equal(got[4], want[4])          # plan_ok
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)  # vx
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)  # wz
    np.testing.assert_array_equal(got[0].wf_goal_idx, want[0].wf_goal_idx)


# ---------------------------------------------------------------------------
# bench config 4 at full width, and the entry points
# ---------------------------------------------------------------------------

def golden_forcing(g, t_):
    """Tick ``t_``'s recorded true pose, twist and MCL state."""
    return dict(pos=torch.as_tensor(g["pos"][t_]),
                quat=torch.as_tensor(g["quat"][t_]),
                v=torch.as_tensor(g["v"][t_]), w=torch.as_tensor(g["w"][t_]),
                mcl=port_mcl_state(g, t_, "cpu"))


def test_config4_matches_golden_teacher_forced():
    """Ticks 0 and 1 of the golden chain at bench config 4's full width
    (64 robots, 1,617 ground nodes, 289 samples of 40 steps, 60 particles),
    on the plain path, each tick started from the recorded true pose and
    MCL state: integer outputs equal, commands, plan poses and MCL errors
    within 1e-5."""
    g = np.load(GOLDEN)
    c4 = entry.config4_inputs(device="cpu")
    state = entry.config4_state(c4, (torch.as_tensor(g["init_pos_n"]),
                                     torch.as_tensor(g["init_rpy_n"])))
    out, _ = entry.run_fleet_full_chain(
        c4, state,
        lambda k: port_draws({n: g[n][k] for n in DRAW_KEYS}, "cpu"),
        2, forced=lambda k: golden_forcing(g, k))
    for f in ("decision", "cmd_source", "ps_simple", "ps_rotate", "plan_ok",
              "wf_iters"):
        np.testing.assert_array_equal(out[f].numpy(), g[f][:2], err_msg=f)
    for f in ("vx", "wz", "plan_pos", "plan_yaw", "mcl_err"):
        np.testing.assert_allclose(out[f].numpy(), g[f][:2], atol=1e-5,
                                   err_msg=f)
    assert (out["decision"][1] == 2).all()       # everyone has a plan


def test_run_fleet_full_chain_carries_state():
    """The entry points at a cut config 4 (2 robots, 3×3 samples of 8
    steps, 8 particles): a 3-tick chain equals its ticks one by one, and
    draws from one torch.Generator seed are reproducible."""
    c4 = entry.config4_inputs(entry.config4_config(3, 3, 8, 32, 16, 256, 32,
                                                   16, 128, 512, 64, 8),
                              entry.config4_world(2, 256), "cpu")

    def run(per_tick):
        gen = torch.Generator().manual_seed(7)
        st = entry.config4_state(c4, tmcl.init_draws(gen, c4.mcl, 2, "cpu"))
        draws = lambda k: tpf.draw_mcl(gen, 2, 8, "cpu")  # noqa: E731
        if not per_tick:
            return entry.run_fleet_full_chain(c4, st, draws, 3)
        outs = []
        for k in range(3):
            o, st = entry.run_fleet_full_chain(c4, st, draws, 1, t0=k)
            outs.append(o)
        return {f: torch.cat([o[f] for o in outs]) for f in outs[0]}, st
    (a, sa), (b, sb) = run(False), run(True)
    assert a["decision"].shape == (3, 2)
    for f in entry.FLEET_DIAG:
        assert torch.equal(a[f], b[f]), f
    assert torch.equal(sa.mcl.particles.pos, sb.mcl.particles.pos)
    assert (a["decision"][-1] >= 2).all()
