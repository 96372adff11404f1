"""The port's zone and path layers (perception/layers.py) and depth-camera
layer (perception/depth_camera.py) against the JAX package, on the CPU.

Each case feeds the same seeded numpy inputs to the JAX function, called
as its call site calls it (eagerly for ``path_blocked``,
``no_entry_dgraph`` and the session's ``speed_limit_at``; jitted for the
depth layer and the fused tick's ``speed_limit_at``), and to the port at
B = 2. Exact equality for masks, grids, indices and ring state; 1e-6 for
distance fields, frustum planes and points (f32 values that only rounding
could move).

Sizes: a 32×32×16 window at 0.1 m, 2 cameras × 3 frames × 128 points.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddmr_navigation_tpu.geometry import (
    quat_from_yaw as j_quat_from_yaw, quat_inverse_rotate as j_qir)
from dddmr_navigation_tpu.io.maps import flat_ground_map
from dddmr_navigation_tpu.perception import depth_camera as jd
from dddmr_navigation_tpu.perception import layers as jl
from dddmr_navigation_tpu.perception.marking import (
    MarkingParams as JParams, init_marking_state as j_init_marking)
from dddmr_navigation_tpu.perception.static_map import (
    build_map_context as j_map_ctx)
from dddmr_navigation_tpu.perception.voxel import VoxelSpec as JSpec
from dddmr_navigation_tpu.planning.local.critics import PrunePlan as JPrune

from dddmr_navigation_tpu_torch.geometry import quat_inverse_rotate_fma
from dddmr_navigation_tpu_torch.interop import to_port
from dddmr_navigation_tpu_torch.perception import depth_camera as td
from dddmr_navigation_tpu_torch.perception import layers as tl
from dddmr_navigation_tpu_torch.perception.marking import (
    MarkingParams, MarkingState, init_marking_state)
from dddmr_navigation_tpu_torch.perception.static_map import (
    build_map_context)
from dddmr_navigation_tpu_torch.perception.voxel import VoxelSpec
from dddmr_navigation_tpu_torch.planning.local.critics import PrunePlan

torch.set_num_threads(1)

SPEC = VoxelSpec(32, 32, 16, 0.1, 0.1)
JSPEC = JSpec(32, 32, 16, 0.1, 0.1)
CAM = td.CameraModel(h_fov=1.2, v_fov=0.9, min_detect_distance=0.3,
                     max_detect_distance=3.0)
JCAM = jd.CameraModel(*CAM)
IDQ = np.array([0.0, 0.0, 0.0, 1.0], np.float32)
P = 128


def t(x):
    return torch.as_tensor(np.array(x))


def yaw_quat(yaw):
    return np.asarray(j_quat_from_yaw(jnp.float32(yaw)))


# ---------------------------------------------------------------------------
# zone and path layers
# ---------------------------------------------------------------------------

def test_path_blocked_matches_eager_jax():
    rng = np.random.default_rng(0)
    b, p, m = 4, 40, 300
    pos = np.cumsum(rng.uniform(0, 0.1, (b, p, 3)), axis=1).astype(np.float32)
    pos[..., 2] = 0.0
    intensity = np.where(np.arange(p) < 5, -1.0, 1.0).astype(np.float32)
    intensity = np.broadcast_to(intensity, (b, p)).copy()
    valid = np.arange(p)[None] < np.array([[40], [30], [0], [20]])
    obs = rng.uniform(-1, 4, (b, m, 3)).astype(np.float32)
    obs[..., 2] = rng.uniform(0, 0.5, (b, m))
    obs_valid = rng.uniform(size=(b, m)) < 0.7
    obs[1] = 10.0                       # robot 1: nothing near its plan
    pp = PrunePlan(t(pos), t(np.zeros((b, p, 4), np.float32)), t(intensity),
                   t(valid), t(valid.sum(1)))
    got = tl.path_blocked(pp, t(obs), t(obs_valid), 0.3).numpy()
    for i in range(b):
        jp = JPrune(jnp.asarray(pos[i]), jnp.zeros((p, 4)),
                    jnp.asarray(intensity[i]), jnp.asarray(valid[i]),
                    jnp.asarray(valid[i].sum()))
        want = bool(jl.path_blocked(jp, jnp.asarray(obs[i]),
                                    jnp.asarray(obs_valid[i]), 0.3))
        assert bool(got[i]) == want, i
    assert got[0] and not got[1] and not got[2]


@pytest.mark.parametrize("fma", [False, True])
def test_speed_limit_at_matches_jax(fma):
    rng = np.random.default_rng(1)
    zp = rng.uniform(-2, 2, (50, 3)).astype(np.float32)
    zp[10] = zp[3]                       # equal minima: the first wins
    speed = rng.uniform(0.1, 0.5, 50).astype(np.float32)
    valid = rng.uniform(size=50) < 0.9
    robots = np.concatenate([rng.uniform(-2, 2, (6, 3)), zp[[3, 7]],
                             [[9.0, 9.0, 0.0]]]).astype(np.float32)
    got = tl.speed_limit_at(t(robots), t(zp), t(valid), t(speed),
                            fma=fma).numpy()
    fn = jax.jit(jl.speed_limit_at) if fma else jl.speed_limit_at
    want = np.array([float(fn(jnp.asarray(r), jnp.asarray(zp),
                              jnp.asarray(valid), jnp.asarray(speed)))
                     for r in robots], np.float32)
    np.testing.assert_array_equal(got, want)
    assert (got > 0).any() and (got == -1).any()


def test_no_entry_dgraph_matches_eager_jax():
    ground = flat_ground_map(8, 6, 0.2)
    xs, ys = np.meshgrid(np.arange(-0.5, 0.51, 0.1), np.arange(1.5, 2.51, 0.1))
    zone = np.stack([xs.ravel(), ys.ravel(), np.zeros(xs.size)],
                    1).astype(np.float32)
    valid = np.ones(len(zone), bool)
    valid[::7] = False
    got = tl.no_entry_dgraph(t(ground), t(np.ones(len(ground), bool)),
                             t(zone), t(valid), 1.5, 9999.0).numpy()
    want = np.asarray(jl.no_entry_dgraph(
        jnp.asarray(ground), jnp.ones(len(ground), bool), jnp.asarray(zone),
        jnp.asarray(valid), inflation_distance=1.5,
        max_obstacle_distance=9999.0))
    np.testing.assert_array_equal(got, want)
    assert (got < 1.5).sum() > 50 and (got == 9999.0).sum() > 50


def test_min_dgraph():
    a, b_, c = t([1.0, 5.0, 3.0]), t([2.0, 4.0, 9.0]), t([0.5, 6.0, 2.0])
    assert tl.min_dgraph(a, b_, c).tolist() == [0.5, 4.0, 2.0]


# ---------------------------------------------------------------------------
# frustum geometry
# ---------------------------------------------------------------------------

def test_quat_inverse_rotate_fma_matches_jitted_jax():
    rng = np.random.default_rng(2)
    q = rng.normal(size=(50, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.uniform(-5, 5, (50, 3)).astype(np.float32)
    want = np.asarray(jax.jit(j_qir)(jnp.asarray(q), jnp.asarray(v)))
    np.testing.assert_array_equal(
        quat_inverse_rotate_fma(t(q), t(v)).numpy(), want)


@pytest.mark.parametrize("cam", [CAM, td.CameraModel()])
def test_frustum_planes_match_jitted_jax(cam):
    rng = np.random.default_rng(3)
    jcam = jd.CameraModel(*cam)
    pos = rng.uniform(-1, 1, (2, 3, 3)).astype(np.float32)
    quat = np.stack([[yaw_quat(y) for y in row]
                     for row in rng.uniform(-3, 3, (2, 3))])
    query = rng.uniform(-3, 3, (2, 3, 400, 3)).astype(np.float32)
    normals, pts = td.frustum_planes(cam, t(pos), t(quat))
    inside = td.in_frustum(normals[:, :, None], pts[:, :, None], t(query))
    planes = jax.jit(jd.frustum_planes, static_argnums=0)
    test = jax.jit(jd.in_frustum)
    for i in range(2):
        for o in range(3):
            jn, jp = planes(jcam, pos[i, o], quat[i, o])
            np.testing.assert_array_equal(normals[i, o].numpy(),
                                          np.asarray(jn))
            np.testing.assert_array_equal(pts[i, o].numpy(), np.asarray(jp))
            np.testing.assert_array_equal(
                inside[i, o].numpy(), np.asarray(test(jn, jp, query[i, o])))
    assert inside.any() and not inside.all()


def test_frustum_axis_points_and_rotated_camera():
    normals, pts = td.frustum_planes(CAM, torch.zeros(3), t(IDQ))
    q = t([[1.0, 0, 0], [0.2, 0, 0], [4.0, 0, 0], [1.0, 0.9, 0],
           [1.0, 0.5, 0], [1.0, 0, 0.6]])
    assert td.in_frustum(normals, pts, q).tolist() == [
        True, False, False, False, True, False]
    normals, pts = td.frustum_planes(CAM, t([1.0, 0.0, 0.0]),
                                     t(yaw_quat(np.pi / 2)))
    assert bool(td.in_frustum(normals, pts, t([1.0, 1.5, 0.0])))
    assert not bool(td.in_frustum(normals, pts, t([2.5, 0.0, 0.0])))


def test_depth_image_to_points_matches_jax():
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.0, 3.0, (12, 16)).astype(np.float32)
    depth[0, :4] = 0.0
    pts, mask = td.depth_image_to_points(t(depth), 10.0, 11.0, 7.5, 5.5, 0.5)
    jp, jm = jd.depth_image_to_points(jnp.asarray(depth), 10.0, 11.0, 7.5,
                                      5.5, 0.5)
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(
        td.optical_to_forward(pts).numpy(),
        np.asarray(jd.optical_to_forward(jp)))


# ---------------------------------------------------------------------------
# the observation ring
# ---------------------------------------------------------------------------

def pad(pts, n=P):
    p = np.zeros((n, 3), np.float32)
    m = np.zeros((n,), bool)
    p[:len(pts)] = pts
    m[:len(pts)] = True
    return p, m


def test_ring_overwrites_oldest_and_expires():
    """`test_perception_layers.py::test_depth_buffer_ring_overwrites_oldest`
    for two robots, and the port's ring state equals JAX's push by push."""
    buf = td.init_depth_buffer(2, 2, 8, robots=2, device="cpu")
    jbuf = jd.init_depth_buffer(2, 2, 8)
    pts, mask = pad(np.ones((3, 3), np.float32), 8)
    for k, st in enumerate((0.0, 0.1, 0.2)):
        cp = np.array([st, 0, 0], np.float32)
        buf = td.push_observation(
            buf, 0, t(np.stack([cp, cp + 1])), t(np.stack([IDQ, IDQ])),
            t(np.stack([pts, pts + k])), t(np.stack([mask, mask])),
            torch.tensor(np.float32(st)))
        jbuf = jd.push_observation(jbuf, 0, jnp.asarray(cp), IDQ, pts, mask,
                                   jnp.float32(st))
    for f in jd.DepthCameraBuffer._fields:
        np.testing.assert_array_equal(getattr(buf, f)[0].numpy(),
                                      np.asarray(getattr(jbuf, f)), f)
    np.testing.assert_allclose(np.sort(buf.stamp[1, 0].numpy()), [0.1, 0.2],
                               atol=1e-6)
    assert buf.points[1, 0, int(buf.head[1, 0]) - 1, 0, 0] == 3.0
    for now, keep in ((0.25, 1.0), (0.25, 0.12), (2.0, 1.0)):
        live = td.live_observations(buf, now, keep)
        want = np.asarray(jd.live_observations(jbuf, now, keep))
        np.testing.assert_array_equal(live[0].numpy(), want)
        latest = td.latest_live_observations(buf, now, keep)
        jlat = jd.latest_live_observations(jbuf, now, keep)
        for f in jd.DepthCameraObservation._fields:
            np.testing.assert_array_equal(getattr(latest, f)[0].numpy(),
                                          np.asarray(getattr(jlat, f)), f)
        obs, olive = td.buffer_as_observations(buf, now, keep)
        jobs, jolive = jd.buffer_as_observations(jbuf, now, keep)
        np.testing.assert_array_equal(olive[0].numpy(), np.asarray(jolive))
        np.testing.assert_array_equal(obs.mask[0].numpy(),
                                      np.asarray(jobs.mask))
    assert not td.live_observations(buf, 0.25, 1.0)[0, 1].any()


# ---------------------------------------------------------------------------
# mark and clear, against the jitted JAX functions
# ---------------------------------------------------------------------------

ORIGIN = np.array([-16, -16, -8], np.int32)


def wall_obs(x=1.5, cam=(0.0, 0.0, 0.0), quat=IDQ):
    ys, zs = np.meshgrid(np.linspace(-0.4, 0.4, 12), np.linspace(-0.3, 0.3, 8))
    wall = np.stack([np.full(ys.size, x), ys.ravel(), zs.ravel()], 1)
    p, m = pad(wall[:P])
    return np.asarray(cam, np.float32), quat, p, m


def jobs_of(obs_list):
    return jd.DepthCameraObservation(
        *(jnp.asarray(np.stack([o[i] for o in obs_list])) for i in range(4)))


def tobs_of(per_robot):
    return td.DepthCameraObservation(
        *(t(np.stack([np.stack([o[i] for o in obs]) for obs in per_robot]))
          for i in range(4)))


def marked_grid():
    grid = jd.mark_depth_points(
        JSPEC, jnp.zeros((32, 32, 16), jnp.uint8), jnp.asarray(ORIGIN),
        jobs_of([wall_obs()]), -0.5, 2.0)
    assert int(grid.sum()) > 20
    return np.asarray(grid)


def test_mark_depth_points_matches_jitted_jax():
    rng = np.random.default_rng(5)
    per_robot, grids, jgrids = [], [], []
    mark = jax.jit(jd.mark_depth_points, static_argnums=(0, 5))
    for i in range(2):
        obs = []
        for c in range(2):
            p = rng.uniform(-2, 2, (P, 3)).astype(np.float32)
            p[:, 2] = rng.uniform(-0.9, 1.0, P)
            obs.append((np.zeros(3, np.float32), IDQ, p,
                        rng.uniform(size=P) < 0.8))
        per_robot.append(obs)
        g0 = (rng.uniform(size=(32, 32, 16)) < 0.01).astype(np.uint8)
        grids.append(g0)
        jgrids.append(np.asarray(mark(JSPEC, jnp.asarray(g0),
                                      jnp.asarray(ORIGIN), jobs_of(obs),
                                      jnp.float32(-0.3 * i), 1.2)))
    got = td.mark_depth_points(SPEC, t(np.stack(grids)),
                               t(np.stack([ORIGIN, ORIGIN])),
                               tobs_of(per_robot), t([0.0, -0.3]), 1.2)
    np.testing.assert_array_equal(got.numpy(), np.stack(jgrids))
    assert (got.numpy() > np.stack(grids)).any()


CLEAR_CASES = {
    # the same wall: re-observed (attached) voxels stay
    "same": [wall_obs()],
    # the wall moved back: the old voxels are seen through and cleared
    "far": [wall_obs(2.5)],
    # a camera behind the first sees through the wall's place
    "cross": [wall_obs(2.8, cam=(-0.2, 0.0, 0.0))],
    # two observations, one looking away
    "mixed": [wall_obs(2.5), wall_obs(2.5, quat=yaw_quat(np.pi / 2))],
}


@pytest.mark.parametrize("case", sorted(CLEAR_CASES))
def test_clear_with_frustums_matches_jitted_jax(case):
    grid = marked_grid()
    n0 = int(grid.sum())
    obs = CLEAR_CASES[case]
    clear = jax.jit(jd.clear_with_frustums, static_argnums=(0, 1))
    live = np.array([True] * len(obs))
    live[-1] = case != "mixed"
    want = np.asarray(clear(JSPEC, JCAM, jnp.asarray(grid),
                            jnp.asarray(ORIGIN), jobs_of(obs),
                            live=jnp.asarray(live)))
    # robot 1 carries an empty grid: nothing to clear
    got = td.clear_with_frustums(
        SPEC, CAM, t(np.stack([grid, np.zeros_like(grid)])),
        t(np.stack([ORIGIN, ORIGIN])), tobs_of([obs, obs]),
        live=t(np.stack([live, live])))
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert int(got[1].sum()) == 0
    if case == "same":
        assert int(want.sum()) > 0.8 * n0
    else:
        assert int(want.sum()) < 0.2 * n0


def test_older_frustum_clears_until_expiry():
    """`test_perception_layers.py::test_older_frustum_still_clears_until_
    expiry`: a live older frame still clears after the camera looked away;
    expired frames clear nothing."""
    grid = marked_grid()
    n0 = int(grid.sum())
    far = np.stack([np.full(8, 2.5), np.linspace(-0.4, 0.4, 8),
                    np.zeros(8)], 1)
    side = np.stack([np.zeros(8), np.full(8, 2.5), np.zeros(8)], 1)
    buf = td.init_depth_buffer(1, 2, P, robots=1, device="cpu")
    jbuf = jd.init_depth_buffer(1, 2, P)
    for pts, quat, st in ((far, IDQ, 0.0), (side, yaw_quat(np.pi / 2), 0.2)):
        p, m = pad(pts)
        buf = td.push_observation(buf, 0, torch.zeros(1, 3), t(quat)[None],
                                  t(p)[None], t(m)[None], t(np.float32(st)))
        jbuf = jd.push_observation(jbuf, 0, jnp.zeros(3), quat, p, m,
                                   jnp.float32(st))
    clear = jax.jit(jd.clear_with_frustums, static_argnums=(0, 1))
    counts = []
    for now in (0.3, 1.5):
        obs, live = td.buffer_as_observations(buf, now, 1.0)
        got = td.clear_with_frustums(SPEC, CAM, t(grid)[None], t(ORIGIN)[None],
                                     obs, live=live)
        jo, jlive = jd.buffer_as_observations(jbuf, now, 1.0)
        want = np.asarray(clear(JSPEC, JCAM, jnp.asarray(grid),
                                jnp.asarray(ORIGIN), jo, live=jlive))
        np.testing.assert_array_equal(got[0].numpy(), want)
        counts.append(int(want.sum()))
    assert counts[0] < 0.2 * n0 and counts[1] == n0


def test_attach_chunks_do_not_change_the_result(monkeypatch):
    grid = marked_grid()
    obs = tobs_of([CLEAR_CASES["mixed"]])
    args = (SPEC, CAM, t(grid)[None], t(ORIGIN)[None], obs)
    whole = td.clear_with_frustums(*args)
    monkeypatch.setattr(td, "ATTACH_CHUNK", 3 * 2 * P)
    assert torch.equal(td.clear_with_frustums(*args), whole)


def test_depth_layer_update_matches_jitted_jax():
    """Three layer ticks of two robots with their own rings (two cameras,
    three frames, 128 points), from frames pushed at 10 Hz, against the
    jitted JAX update robot by robot: grid, origin and distance field."""
    rng = np.random.default_rng(6)
    ground = flat_ground_map(6, 4, 0.2)
    jparams = JParams(max_marked_voxels=256, max_window_nodes=1024)
    params = MarkingParams(max_marked_voxels=256, max_window_nodes=1024)
    jctx = j_map_ctx(ground)
    ctx = build_map_context(ground, device="cpu")
    robots = np.array([[-0.5, 0.0, 0.0], [0.3, -0.4, 0.0]], np.float32)
    quats = np.stack([yaw_quat(0.2), yaw_quat(-0.4)])
    g = len(ground)
    marking = init_marking_state(SPEC, params, g, t(robots))
    buf = td.init_depth_buffer(2, 3, P, robots=2, device="cpu")
    jmark = [j_init_marking(JSPEC, jparams, g, robots[i]) for i in range(2)]
    jbuf = [jd.init_depth_buffer(2, 3, P) for _ in range(2)]
    upd = jax.jit(jd.depth_layer_update, static_argnums=(0, 1, 2, 6))
    for tick in range(3):
        now = np.float32(0.1 * tick)
        for c in range(2):
            frames = []
            for i in range(2):
                n = rng.integers(60, P)
                p = np.zeros((P, 3), np.float32)
                p[:n] = robots[i] + rng.uniform([0.4, -1, 0.0], [1.5, 1, 1.2],
                                                (n, 3))
                m = np.arange(P) < n
                cp = robots[i] + np.array([0.1 * c, 0, 0.4], np.float32)
                frames.append((cp, quats[i], p, m))
                jbuf[i] = jd.push_observation(jbuf[i], c, cp, quats[i], p, m,
                                              jnp.float32(now))
            buf = td.push_observation(
                buf, c, *(t(np.stack([f[k] for f in frames]))
                          for k in range(4)), t(now))
        marking, latest = td.depth_layer_update(
            SPEC, params, CAM, marking, buf, t(now), 0.5, ctx, t(robots),
            t(quats))
        for i in range(2):
            jmark[i], jlat = upd(JSPEC, jparams, JCAM, jmark[i], jbuf[i],
                                 jnp.float32(now), 0.5, jctx, robots[i],
                                 quats[i])
            np.testing.assert_array_equal(marking.grid[i].numpy(),
                                          np.asarray(jmark[i].grid))
            np.testing.assert_array_equal(marking.origin[i].numpy(),
                                          np.asarray(jmark[i].origin))
            np.testing.assert_allclose(marking.dgraph[i].numpy(),
                                       np.asarray(jmark[i].dgraph), atol=1e-6)
            np.testing.assert_array_equal(latest.mask[i].numpy(),
                                          np.asarray(jlat.mask))
        robots = robots + np.array([0.15, 0.05, 0.0], np.float32)
    assert int(marking.grid.sum()) > 20
    assert (marking.dgraph < 0.5).any()
    state = to_port(jax.tree_util.tree_map(
        lambda *x: np.stack([np.asarray(a) for a in x]), *jmark),
        MarkingState, "cpu")
    assert torch.equal(state.grid, marking.grid)
