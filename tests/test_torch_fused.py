"""The port's fused perception → replan → local tick
(dddmr_navigation_tpu_torch.control.fused) against the JAX package, on
the CPU, and the port's config-3 golden file.

Sizes: the light configuration of ``test_fused_vertical.py`` (a 64×64×24
window, 512 marked voxels, 5×7 samples of 24 steps, 512 observation
points, near-K 64) on a reduced ``multi_level_map(resolution=0.5)`` with
``turning_weight`` 0.1; ``flat_ground_map(10, 6, 0.25)`` for the map
tables. Tolerances: exact for masks, grids, node ids, counts, iteration
counts and state codes; 1e-5 m for distance fields, observation points
and plan positions; best indices equal or a tie whose JAX costs differ by
at most 1e-5 (XLA's and PyTorch's exp, sin and cos differ at the ulp
level, and a regular grid has many paths of equal cost).
"""
import dataclasses
import os
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddmr_navigation_tpu.geometry import quat_from_yaw as j_quat_from_yaw
from dddmr_navigation_tpu.io.maps import flat_ground_map
from dddmr_navigation_tpu.control import fused as jf
from dddmr_navigation_tpu.perception.static_map import (
    MapContext as JMapContext)
from dddmr_navigation_tpu.planning.global_.planner import (
    plan_on_graph as j_plan_on_graph)
from dddmr_navigation_tpu.planning.local.planner import (
    compute_velocity_command as j_cvc)

from dddmr_navigation_tpu_torch import entry
from dddmr_navigation_tpu_torch.control import fused as tf
from dddmr_navigation_tpu_torch.interop import tensor, to_port, to_numpy
from dddmr_navigation_tpu_torch.perception.marking import MarkingState
from dddmr_navigation_tpu_torch.perception.static_map import MapContext
from dddmr_navigation_tpu_torch.planning.global_.planner import (
    GlobalPathResult)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                      "config3_golden.npz")


def light_cfg():
    """``test_fused_vertical._light_cfg``'s sizes, on config 3's lidar
    (a 16×256 sweep, every azimuth effective)."""
    cfg = entry.config3_config(4, 6, 24, 64, 24, 16, 256, 512, 64)
    return dataclasses.replace(cfg, perception=dataclasses.replace(
        cfg.perception, max_marked_voxels=512))


def t(x):
    return torch.as_tensor(np.array(x))


def stack_np(trees):
    return jax.tree_util.tree_map(lambda *x: np.stack(x), *trees)


def assert_best_index(port_idx, jax_idx, jax_costs, tol=1e-5):
    for b in np.flatnonzero(np.asarray(port_idx) != np.asarray(jax_idx)):
        c = np.asarray(jax_costs)[b]
        gap = abs(float(c[port_idx[b]]) - float(c[jax_idx[b]]))
        assert gap <= tol, (b, port_idx[b], jax_idx[b], gap)
        warnings.warn(f"robot {b}: best index {port_idx[b]} vs JAX "
                      f"{jax_idx[b]}, a tie within {gap:.2e}")


# ---------------------------------------------------------------------------
# the map tables, and carrying JAX state into the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flat():
    cfg = light_cfg()
    ground = flat_ground_map(10, 6, 0.25)
    return cfg, ground, jf.build_fused_map(cfg, ground)


def sparse_ground():
    """Random nodes ~0.65 m apart: the kNN fallback makes long edges, so
    the LOS-relevant mask is not empty."""
    rng = np.random.default_rng(3)
    return rng.uniform([0, 0, 0], [8, 8, 0], size=(150, 3)).astype(np.float32)


@pytest.mark.parametrize("which", ["flat", "sparse"])
def test_build_fused_map_matches_jax(flat, which):
    cfg, ground, jmap = flat
    if which == "sparse":
        ground = sparse_ground()
        jmap = jf.build_fused_map(cfg, ground)
        assert np.asarray(jmap.los_relevant).any()
    got = tf.build_fused_map(cfg, ground, device="cpu")
    want = to_port(jax.tree_util.tree_map(np.asarray, jmap), tf.FusedMap,
                   "cpu")
    for f in tf.FusedMap._fields:
        if f in ("map_ctx", "wf_az", "turn_pen"):
            continue
        if getattr(want, f) is None:            # the zone fields, no zones
            assert getattr(got, f) is None, f
            continue
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    torch.testing.assert_close(got.wf_az, want.wf_az, atol=1e-6, rtol=0)
    torch.testing.assert_close(got.turn_pen, want.turn_pen, atol=1e-6,
                               rtol=0)
    for f in dataclasses.fields(MapContext):
        a, b = getattr(got.map_ctx, f.name), getattr(want.map_ctx, f.name)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), f.name


def test_interop_keeps_small_types():
    grid = np.zeros((4, 4, 2), np.uint8)
    assert tensor(grid, "cpu").dtype == torch.uint8
    assert tensor(np.arange(3, dtype=np.int32), "cpu").dtype == torch.int32
    assert tensor(np.ones(2, bool), "cpu").dtype == torch.bool
    assert tensor(np.arange(3, dtype=np.uint32), "cpu").dtype == torch.int64
    assert tensor(np.ones(2), "cpu").dtype == torch.float32


def test_interop_carries_nested_state_and_map_context(flat):
    cfg, ground, jmap = flat
    jstates = [jf.init_fused_state(cfg, len(ground), robot_xyz=np.array(
        [x, 0.0, 0.0], np.float32)) for x in (0.0, 1.0)]
    state = to_port(stack_np(jstates), tf.FusedState, "cpu")
    assert isinstance(state.marking, MarkingState)
    assert state.marking.grid.dtype == torch.uint8
    assert state.marking.grid.shape == (2, 64, 64, 24)
    assert state.marking.origin.dtype == torch.int32
    assert state.wf_dist.shape == (2, len(ground), 16)
    ctx = to_port(jax.tree_util.tree_map(np.asarray, jmap.map_ctx),
                  MapContext, "cpu")
    assert isinstance(jmap.map_ctx, JMapContext)
    assert ctx.static_occ.dtype == torch.uint8
    assert ctx.height_res == jmap.map_ctx.height_res
    back = to_numpy(ctx)
    np.testing.assert_array_equal(back.height, np.asarray(jmap.map_ctx.height))


# ---------------------------------------------------------------------------
# observation and path interpolation
# ---------------------------------------------------------------------------

def test_device_observation_matches_jax():
    rng = np.random.default_rng(0)
    # clumps, so voxels hold several points; some masked
    centers = rng.uniform(-2, 2, size=(2, 60, 3))
    pts = (centers[:, rng.integers(0, 60, 900)]
           + rng.normal(0, 0.04, size=(2, 900, 3))).astype(np.float32)
    mask = rng.uniform(size=(2, 900)) < 0.8
    fn = jax.jit(jf.device_observation, static_argnums=(2,))
    for k in (64, 2048):
        got_p, got_m = tf.device_observation(t(pts), t(mask), k)
        for b in range(2):
            wp, wm = fn(pts[b], mask[b], k)
            np.testing.assert_array_equal(got_m[b].numpy(), np.asarray(wm))
            np.testing.assert_array_equal(got_p[b].numpy(), np.asarray(wp))


def test_interpolate_path_device_matches_jax(flat):
    cfg, ground, jmap = flat
    starts = np.array([[-4.0, -2.0, 0.0], [4.5, 2.5, 0.0]], np.float32)
    goals = np.array([[4.0, 2.25, 0.0], [-4.5, -2.75, 0.0]], np.float32)
    dg = np.full(len(ground), 9999.0, np.float32)
    dg[(np.abs(ground[:, 0]) < 0.6) & (ground[:, 1] < 1.5)] = 0.2  # a wall
    gp = cfg.global_planner
    plan_fn = jax.jit(lambda s, g: j_plan_on_graph(
        gp, jmap.nbr_idx, jmap.nbr_dist, jmap.nbr_valid, jmap.ground,
        jmap.ground_valid, dg, jmap.node_weight, jmap.avg_intensity, s, g,
        inscribed_radius=0.5, inflation_descending_rate=2.0,
        turn_pen=jmap.turn_pen, wf_az=jmap.wf_az, wf_bins=jmap.wf_bins))
    interp = jax.jit(lambda r: jf.interpolate_path_device(
        jmap.ground, r, max_plan_len=512))
    results = [plan_fn(starts[b], goals[b]) for b in range(2)]
    res = to_port(stack_np([jax.tree_util.tree_map(np.asarray, r)
                            for r in results]), GlobalPathResult, "cpu")
    got = tf.interpolate_path_device(t(ground), res, max_plan_len=512)
    for b in range(2):
        want = interp(results[b])
        assert bool(want.count > 40)
        np.testing.assert_array_equal(got.count[b].numpy(),
                                      np.asarray(want.count))
        np.testing.assert_array_equal(got.valid[b].numpy(),
                                      np.asarray(want.valid))
        np.testing.assert_allclose(got.positions[b].numpy(),
                                   np.asarray(want.positions), atol=1e-5)
        np.testing.assert_allclose(got.quats[b].numpy(),
                                   np.asarray(want.quats), atol=1e-5)


# ---------------------------------------------------------------------------
# the whole tick, batched, and a chain with the state carried
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """The light configuration on the reduced multi-level map: the port's
    Config3 and the JAX package's map and jitted tick."""
    cfg = light_cfg()
    md = entry.config3_map(resolution=0.5)
    c3 = entry.config3_inputs(cfg, "cpu", map_data=md)
    ground, map_pts, weights, static_dgraph = md
    jmap = jf.build_fused_map(cfg, ground, map_pts, node_weight=weights,
                              static_dgraph=static_dgraph)
    jtick = jf.make_fused_tick(cfg)[0]
    jcmd = jax.jit(lambda plan, pos, quat, v, w, obs, m: j_cvc(
        cfg.local_planner, plan, pos, quat, v, w, obs, m,
        allowed_max_speed=-1.0).costs)
    return cfg, c3, jmap, jtick, jcmd


# (position, yaw, v, w) of two robots; the second beside an extra box
POSES = [((8.5, 7.0, 0.0), 0.0, 0.3, 0.0), ((2.0, 6.0, 0.0), 1.0, 0.2, 0.3)]
EXTRA_BOX = ((2.3, 6.8, 0.0), (2.8, 7.2, 1.0))


def scan_inputs(cfg, poses, world):
    pos = np.array([p for p, *_ in poses], np.float32)
    yaw = np.array([y for _, y, *_ in poses], np.float32)
    quat = np.stack([np.asarray(j_quat_from_yaw(jnp.float32(y))) for y in yaw])
    scans = [entry.config3_scan(cfg, world, pos[b], float(yaw[b]))
             for b in range(len(poses))]
    return (pos, quat, np.stack([s[0] for s in scans]),
            np.stack([s[1] for s in scans]),
            np.array([v for *_, v, _ in poses], np.float32),
            np.array([w for *_, w in poses], np.float32))


def compare_tick(cfg, jcmd, out, jouts, state, jstates, pos, quat, v, w):
    for b, jo in enumerate(jouts):
        for f in ("state", "plan_ok", "wf_iters"):
            assert int(getattr(out, f)[b]) == int(getattr(jo, f)), f
        assert int(out.plan.count[b]) == int(jo.plan.count)
        np.testing.assert_array_equal(out.obs_mask[b].numpy(),
                                      np.asarray(jo.obs_mask))
        np.testing.assert_allclose(out.obs[b].numpy(), np.asarray(jo.obs),
                                   atol=1e-5)
        np.testing.assert_allclose(out.composed_dgraph[b].numpy(),
                                   np.asarray(jo.composed_dgraph), atol=1e-5)
        np.testing.assert_allclose(out.plan.positions[b].numpy(),
                                   np.asarray(jo.plan.positions), atol=1e-5)
        costs = jcmd(jo.plan, pos[b], quat[b], v[b], w[b], jo.obs,
                     jo.obs_mask)
        want_best = int(np.argmin(np.where(np.asarray(costs) < 0, np.inf,
                                           np.asarray(costs))[::-1]))
        want_best = costs.shape[0] - 1 - want_best
        if bool(jo.state == 4):
            assert_best_index(out.best_index[b:b + 1].numpy(),
                              np.array([want_best]), np.asarray(costs)[None])
        np.testing.assert_allclose(out.vx[b].numpy(), np.asarray(jo.vx),
                                   atol=1e-5)
        np.testing.assert_allclose(out.wz[b].numpy(), np.asarray(jo.wz),
                                   atol=1e-5)
        js = jstates[b]
        np.testing.assert_array_equal(state.marking.grid[b].numpy(),
                                      np.asarray(js.marking.grid))
        assert int(state.wf_goal_idx[b]) == int(js.wf_goal_idx)
        want_wf = np.asarray(js.wf_dist)
        np.testing.assert_array_equal(np.isinf(state.wf_dist[b].numpy()),
                                      np.isinf(want_wf))
        fin = np.isfinite(want_wf)
        np.testing.assert_allclose(state.wf_dist[b].numpy()[fin],
                                   want_wf[fin], rtol=1e-5)


def test_fused_tick_batched_matches_two_jax_ticks(small):
    cfg, c3, jmap, jtick, jcmd = small
    world = entry.config3_world([EXTRA_BOX])
    pos, quat, scans, masks, v, w = scan_inputs(cfg, POSES, world)
    goal = np.tile(c3.goal, (2, 1))
    state = tf.init_fused_state(cfg, c3.fmap.ground.shape[0], t(pos))
    state, out = c3.tick(c3.fmap, state, t(scans), t(masks), t(pos), t(quat),
                         t(c3.offset), t(goal), t(v), t(w))
    jstates, jouts = [], []
    for b in range(2):
        js = jf.init_fused_state(cfg, c3.fmap.ground.shape[0],
                                 robot_xyz=pos[b])
        js, jo = jtick(jmap, js, scans[b], masks[b], pos[b], quat[b],
                       c3.offset, goal[b], v[b], w[b])
        jstates.append(js)
        jouts.append(jo)
    compare_tick(cfg, jcmd, out, jouts, state, jstates, pos, quat, v, w)
    assert int(state.marking.grid[1].sum()) > 0
    assert bool(out.plan_ok.all())


def test_fused_chain_five_ticks_matches_jax(small):
    """Five ticks with the state carried on both sides; the robots move as
    the JAX package's commands take them (the same poses go to both)."""
    cfg, c3, jmap, jtick, jcmd = small
    world = entry.config3_world([EXTRA_BOX])
    poses = [list(p) for p in POSES]
    goal = np.tile(c3.goal, (2, 1))
    g = c3.fmap.ground.shape[0]
    state = tf.init_fused_state(cfg, g, t([p[0] for p in poses]))
    jstates = [jf.init_fused_state(cfg, g, robot_xyz=np.array(p[0],
                                                              np.float32))
               for p in poses]
    iters = []
    for _ in range(5):
        pos, quat, scans, masks, v, w = scan_inputs(cfg, poses, world)
        state, out = c3.tick(c3.fmap, state, t(scans), t(masks), t(pos),
                             t(quat), t(c3.offset), t(goal), t(v), t(w))
        jouts = []
        for b in range(2):
            jstates[b], jo = jtick(jmap, jstates[b], scans[b], masks[b],
                                   pos[b], quat[b], c3.offset, goal[b], v[b],
                                   w[b])
            jouts.append(jo)
        compare_tick(cfg, jcmd, out, jouts, state, jstates, pos, quat, v, w)
        iters.append(out.wf_iters.tolist())
        for b, jo in enumerate(jouts):
            vx, wz = float(jo.vx), float(jo.wz)
            (x, y, z), yaw = poses[b][0], poses[b][1] + wz * 0.1
            poses[b] = [(x + vx * np.cos(yaw) * 0.1,
                         y + vx * np.sin(yaw) * 0.1, z), yaw, vx, wz]
    # the first tick solves cold, later ones warm-start
    assert all(i[0] < iters[0][0] for i in iters[1:]), iters


def test_unported_options_raise(small):
    """The former stand-ins are gone: depth cameras, zones, the DWA
    manager and the runtime are accepted and importable."""
    cfg, c3, *_ = small
    from dddmr_navigation_tpu_torch.perception.depth_camera import (
        CameraModel)
    assert tf.make_fused_tick(cfg, depth_cam=CameraModel())[0] is not None
    state = tf.init_fused_state(cfg, 4, torch.zeros(1, 3), depth_cameras=1)
    assert state.depth_buffer.points.shape == (1, 1, 3, 512, 3)
    fmap = tf.build_fused_map(cfg, flat_ground_map(2, 2, 0.5),
                              no_entry_zones=np.zeros((1, 3)), device="cpu")
    assert fmap.no_entry_field.shape == (25,)
    from dddmr_navigation_tpu_torch.planning.global_ import dwa, runtime
    assert dwa.DWAGlobalPlanManager and runtime.GlobalPlannerRuntime


# a no-entry patch between robot 0 and the ramp; a slow zone around robot 1
NO_ENTRY = np.stack(np.meshgrid(np.arange(6.0, 7.01, 0.25),
                                np.arange(6.0, 7.51, 0.25), [0.0]),
                    -1).reshape(-1, 3).astype(np.float32)
SPEED_PTS = np.stack(np.meshgrid(np.arange(1.0, 3.01, 0.25),
                                 np.arange(5.0, 7.01, 0.25), [0.0]),
                     -1).reshape(-1, 3).astype(np.float32)


def depth_frames(rng, pos, quat, n_cams=2, p=512):
    """Each robot's frames of two cameras 0.4 m above it, one looking
    ahead and one 0.5 rad to the left: points on a wall 1.2 m ahead (world
    frame), a random share of them masked."""
    b = len(pos)
    cam_pos = np.zeros((b, n_cams, 3), np.float32)
    cam_quat = np.zeros((b, n_cams, 4), np.float32)
    pts = np.zeros((b, n_cams, p, 3), np.float32)
    mask = np.zeros((b, n_cams, p), bool)
    for i in range(b):
        yaw0 = 2.0 * np.arctan2(quat[i, 2], quat[i, 3])
        for c in range(n_cams):
            yaw = yaw0 + 0.5 * c
            cam_pos[i, c] = pos[i] + np.array([0.0, 0.0, 0.4], np.float32)
            cam_quat[i, c] = np.asarray(j_quat_from_yaw(jnp.float32(yaw)))
            n = int(rng.integers(p // 2, p))
            lat = rng.uniform(-0.5, 0.5, n)
            fwd = 1.2 + rng.normal(0, 0.02, n)
            pts[i, c, :n, 0] = pos[i, 0] + fwd * np.cos(yaw) - lat * np.sin(yaw)
            pts[i, c, :n, 1] = pos[i, 1] + fwd * np.sin(yaw) + lat * np.cos(yaw)
            pts[i, c, :n, 2] = pos[i, 2] + rng.uniform(0.05, 0.9, n)
            mask[i, c, :n] = rng.uniform(size=n) < 0.9
    return cam_pos, cam_quat, pts, mask


def test_fused_chain_with_depth_and_zones_matches_jax(small):
    """Three B = 2 ticks with two depth cameras (3-deep rings) and both
    zone layers, against the jitted JAX tick robot by robot: frames pushed
    on ticks 0 and 1, a frame-less tick 2 that still clears and marks from
    the ring, the no-entry toggle off for robot 1 on tick 1. Also the depth
    layer's grid and ring, exactly."""
    from dddmr_navigation_tpu.perception.depth_camera import (
        CameraModel as JCam)
    from dddmr_navigation_tpu_torch.perception.depth_camera import (
        CameraModel)
    cfg, c3, *_ = small
    md = entry.config3_map(resolution=0.5)
    ground, map_pts, weights, static_dgraph = md
    zones = dict(no_entry_zones=NO_ENTRY,
                 speed_zones=(SPEED_PTS, np.full(len(SPEED_PTS), 0.1,
                                                 np.float32)))
    jmap = jf.build_fused_map(cfg, ground, map_pts, node_weight=weights,
                              static_dgraph=static_dgraph, **zones)
    fmap = tf.build_fused_map(cfg, ground, map_pts, node_weight=weights,
                              static_dgraph=static_dgraph, device="cpu",
                              **zones)
    np.testing.assert_array_equal(fmap.no_entry_field.numpy(),
                                  np.asarray(jmap.no_entry_field))
    assert (fmap.no_entry_field < 1.5).any()
    jtick = jf.make_fused_tick(cfg, depth_cam=JCam())[0]
    tick = tf.make_fused_tick(cfg, depth_cam=CameraModel())[0]
    world = entry.config3_world([EXTRA_BOX])
    pos, quat, scans, masks, v, w = scan_inputs(cfg, POSES, world)
    goal = np.tile(c3.goal, (2, 1))
    g = len(ground)
    state = tf.init_fused_state(cfg, g, t(pos), depth_cameras=2)
    jstates = [jf.init_fused_state(cfg, g, robot_xyz=pos[b], depth_cameras=2)
               for b in range(2)]
    rng = np.random.default_rng(7)
    for k in range(3):
        now = np.float32(0.1 * k)
        frames = depth_frames(rng, pos, quat) if k < 2 else None
        enabled = np.array([True, k != 1])
        state, out = tick(fmap, state, t(scans), t(masks), t(pos), t(quat),
                          t(c3.offset), t(goal), t(v), t(w),
                          depth_frames=None if frames is None else tuple(
                              t(f) for f in frames),
                          now=t(now), no_entry_enabled=t(enabled))
        for b in range(2):
            jf_b = None if frames is None else tuple(f[b] for f in frames)
            jstates[b], jo = jtick(jmap, jstates[b], scans[b], masks[b],
                                   pos[b], quat[b], c3.offset, goal[b], v[b],
                                   w[b], depth_frames=jf_b, now=now,
                                   no_entry_enabled=bool(enabled[b]))
            assert int(out.state[b]) == int(jo.state)
            assert int(out.plan.count[b]) == int(jo.plan.count)
            assert int(out.wf_iters[b]) == int(jo.wf_iters)
            np.testing.assert_array_equal(out.obs_mask[b].numpy(),
                                          np.asarray(jo.obs_mask))
            np.testing.assert_allclose(out.obs[b].numpy(),
                                       np.asarray(jo.obs), atol=1e-5)
            np.testing.assert_allclose(out.composed_dgraph[b].numpy(),
                                       np.asarray(jo.composed_dgraph),
                                       atol=1e-5)
            np.testing.assert_allclose(out.vx[b].numpy(), np.asarray(jo.vx),
                                       atol=1e-5)
            np.testing.assert_allclose(out.wz[b].numpy(), np.asarray(jo.wz),
                                       atol=1e-5)
            js = jstates[b]
            np.testing.assert_array_equal(
                state.depth_marking.grid[b].numpy(),
                np.asarray(js.depth_marking.grid))
            np.testing.assert_allclose(state.depth_marking.dgraph[b].numpy(),
                                       np.asarray(js.depth_marking.dgraph),
                                       atol=1e-5)
            for f in ("stamp", "head", "mask"):
                np.testing.assert_array_equal(
                    getattr(state.depth_buffer, f)[b].numpy(),
                    np.asarray(getattr(js.depth_buffer, f)), f)
    assert int(state.depth_marking.grid.sum()) > 0
    # robot 1 stands in the 0.1 m/s zone
    assert abs(float(out.vx[1])) <= 0.1 + 1e-6


# ---------------------------------------------------------------------------
# config 3 at full width, tick 0, against the golden file
# ---------------------------------------------------------------------------

def test_config3_tick0_matches_golden():
    """Tick 0 of the golden chain (``tools/make_config3_golden.py``) at
    bench config 3's full width, on the plain path."""
    g = np.load(GOLDEN)
    cfg = entry.config3_config()
    c3 = entry.config3_inputs(cfg, "cpu")
    np.testing.assert_array_equal(c3.fmap.wf_bins.numpy(), g["bins"])
    np.testing.assert_allclose(c3.fmap.wf_az.numpy(), g["az"], atol=1e-6)
    np.testing.assert_allclose(c3.fmap.turn_pen.numpy(), g["turn_pen"],
                               atol=1e-6)
    pts, mask = entry.config3_scan(cfg, entry.config3_world(),
                                   g["positions"][0], float(g["yaws"][0]))
    n0 = int(g["scan_count"][0])
    np.testing.assert_array_equal(np.flatnonzero(mask), g["scan_idx"][:n0])
    np.testing.assert_array_equal(pts[mask], g["scan_pts"][:n0])
    state = entry.config3_state(c3)
    _, out = c3.tick(c3.fmap, state, t(pts)[None], t(mask)[None],
                     t(g["positions"][:1]), t(g["quats"][:1]),
                     t(c3.offset), t(c3.goal[None]), t(g["v_in"][:1]),
                     t(g["w_in"][:1]))
    assert int(out.state[0]) == int(g["state"][0])
    assert bool(out.plan_ok[0]) == bool(g["plan_ok"][0])
    assert int(out.plan.count[0]) == int(g["plan_count"][0])
    assert int(out.wf_iters[0]) == int(g["wf_iters"][0])
    assert_best_index(out.best_index.numpy(), g["best_index"][:1],
                      g["costs"][:1])
    np.testing.assert_allclose(out.composed_dgraph[0].numpy(),
                               g["composed_first"], atol=1e-5)
    np.testing.assert_allclose(out.plan.positions[0].numpy(),
                               g["plan_positions"][0], atol=1e-5)
    np.testing.assert_allclose(out.vx[0].numpy(), g["vx"][0], atol=1e-5)
    np.testing.assert_allclose(out.wz[0].numpy(), g["wz"][0], atol=1e-5)
