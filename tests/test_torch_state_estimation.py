"""The port's MCL (dddmr_navigation_tpu_torch.state_estimation) against the
JAX package, on the CPU, on the warehouse of ``tests/test_fleet_full.py``.

The random draws are JAX's own: each JAX call takes a key, and the port
takes the unit draws that key gives, replayed by
``tools/make_config4_golden.py``. Tolerances: exact for the host copies of
the submap preprocessing, resampling indices (hence duplicates and
particle provenance), cumulative sums, counts and flags; 1e-5 for
poses, fields, likelihoods and weights (rtol for likelihoods).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddmr_navigation_tpu.config import MCLConfig
from dddmr_navigation_tpu.geometry import quat_from_rpy as j_quat_from_rpy
from dddmr_navigation_tpu.io.maps import flat_ground_map, box_obstacle
from dddmr_navigation_tpu.state_estimation import pf as jpf
from dddmr_navigation_tpu.state_estimation import likelihood as jlk
from dddmr_navigation_tpu.state_estimation import mcl as jmcl

from dddmr_navigation_tpu_torch.interop import (
    DRAW_KEYS, config_from, mcl_fields, port_draws, port_mcl_state, tensor,
    to_port)
from dddmr_navigation_tpu_torch.rounding import cumsum_xla
from dddmr_navigation_tpu_torch.state_estimation import pf as tpf
from dddmr_navigation_tpu_torch.state_estimation import likelihood as tlk
from dddmr_navigation_tpu_torch.state_estimation import mcl as tmcl

from tools.make_config4_golden import jax_mcl_draws

torch.set_num_threads(1)

B, N = 3, 48
MCL = MCLConfig(num_particles=N, init_var_x=0.3, init_var_y=0.3,
                init_var_z=0.1, init_var_yaw=0.1)


def t(x):
    return tensor(x, "cpu")


def as_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def world():
    ground = flat_ground_map(10, 8, 0.25)
    walls = np.concatenate([
        box_obstacle([-4.6, 0.0, 0.0], size=(0.3, 7.4, 1.2), resolution=0.15),
        box_obstacle([4.6, 0.0, 0.0], size=(0.3, 7.4, 1.2), resolution=0.15),
        box_obstacle([0.0, -3.6, 0.0], size=(9.0, 0.3, 1.2), resolution=0.15),
        box_obstacle([0.0, 3.6, 0.0], size=(9.0, 0.3, 1.2), resolution=0.15),
    ]).astype(np.float32)
    jctx = jlk.build_submap_context(walls, ground, MCL)
    tctx = tlk.build_submap_context(walls, ground, config_from(MCL),
                                    device="cpu")
    return dict(ground=ground, walls=walls, jctx=jctx, tctx=tctx)


def particles(seed=0):
    """B robots' particle clouds near their poses, as numpy."""
    rng = np.random.default_rng(seed)
    center = np.stack([[-3.0 + 2.5 * i, -1.0 + i, 0.0] for i in range(B)])
    pos = (center[:, None] + rng.normal(0, [0.2, 0.2, 0.03], (B, N, 3))
           ).astype(np.float32)
    rpy = rng.normal(0, [0.02, 0.02, 0.3], (B, N, 3)).astype(np.float32)
    rpy[..., 2] += np.arange(B)[:, None] * 0.7
    quat = np.asarray(j_quat_from_rpy(rpy[..., 0], rpy[..., 1], rpy[..., 2]))
    return center.astype(np.float32), pos, quat


def features(world, center, seed=1):
    """Each robot's feature clouds in its base frame (identity rotation):
    256 ground and 512 wall points within 8 m, the last ones masked."""
    rng = np.random.default_rng(seed)
    flat = np.zeros((B, 256, 3), np.float32)
    sharp = np.zeros((B, 512, 3), np.float32)
    for b in range(B):
        g = world["ground"][rng.choice(len(world["ground"]), 256, False)]
        w = world["walls"][rng.choice(len(world["walls"]), 512, False)]
        flat[b] = g - center[b] + rng.normal(0, 0.02, g.shape)
        sharp[b] = w - center[b] + rng.normal(0, 0.02, w.shape)
    fm = np.ones((B, 256), bool)
    sm = np.ones((B, 512), bool)
    fm[:, 240:] = False
    sm[:, 500:] = False
    return flat, fm, sharp, sm


# ---------------------------------------------------------------------------
# rounding, host copies, field samples
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 48, 60, 256, 300])
def test_cumsum_matches_xla(n):
    rng = np.random.default_rng(n)
    x = rng.random((16, n)).astype(np.float32)
    x /= x.sum(1, keepdims=True)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(x))
    np.testing.assert_array_equal(cumsum_xla(t(x)).numpy(), want)


def test_submap_context_host_copies_equal(world):
    j, p = world["jctx"], world["tctx"]
    for name in ("map_field", "ground_field"):
        jf, pf_ = getattr(j, name), getattr(p, name)
        for f in ("dist", "origin", "packed", "near_pt"):
            np.testing.assert_array_equal(getattr(pf_, f).numpy(),
                                          np.asarray(getattr(jf, f)),
                                          err_msg=f"{name}.{f}")
        assert pf_.res == jf.res
    np.testing.assert_array_equal(p.ground_normal.numpy(),
                                  np.asarray(j.ground_normal))
    np.testing.assert_array_equal(p.ground_count.numpy(),
                                  np.asarray(j.ground_count))
    np.testing.assert_array_equal(p.ground_xy_origin.numpy(),
                                  np.asarray(j.ground_xy_origin))
    assert p.ground_xy_res == j.ground_xy_res
    f2 = tlk.build_distance_field(world["walls"][:50], 0.2, 1.0, pack=False,
                                  device="cpu")
    j2 = jlk.build_distance_field(world["walls"][:50], 0.2, 1.0, pack=False)
    np.testing.assert_array_equal(f2.dist.numpy(), np.asarray(j2.dist))
    assert f2.packed is None and f2.near_pt is None


@pytest.mark.parametrize("mode", ["trilinear", "nearest", "nearest_point"])
def test_sample_modes_match_jax(world, mode):
    rng = np.random.default_rng(2)
    pts = rng.uniform([-6, -5, -0.5], [6, 5, 2.0], (B, 400, 3)).astype(
        np.float32)
    pts[:, :20] = rng.uniform(-40, 40, (B, 20, 3))     # off the grid
    for name in ("map_field", "ground_field"):
        jf, pf_ = getattr(world["jctx"], name), getattr(world["tctx"], name)
        if mode == "nearest_point":
            want = jax.jit(lambda p: jlk.sample_nearest_point(jf, p))(pts)
            got = tlk.sample_nearest_point(pf_, t(pts))
            for w, g in zip(want, got):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            want = jax.jit(lambda p: jlk.sample_distance(jf, p, mode))(pts)
            got = tlk.sample_distance(pf_, t(pts), mode)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-5)


def test_pos_weight_matches_jax(world):
    center, pos, quat = particles()
    cfg = config_from(MCL)
    want = jax.jit(jax.vmap(jax.vmap(
        lambda p, q: jlk._pos_weight(world["jctx"], MCL, p, q))))(pos, quat)
    got = tlk._pos_weight(world["tctx"], cfg, t(pos), t(quat))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["trilinear", "nearest", "corr"])
def test_measure_matches_jax(world, mode):
    """All three sampling modes of the likelihood, every particle."""
    center, pos, quat = particles()
    flat, fm, sharp, sm = features(world, center)
    sw = np.random.default_rng(3).uniform(0.5, 2.0, (B, 512)).astype(
        np.float32)
    import dataclasses
    jcfg = dataclasses.replace(MCL, field_sampling=mode)
    cfg = config_from(jcfg)
    pose0_pos = center + np.float32([0.05, -0.03, 0.0])
    pose0_quat = quat[:, 0]
    if mode == "corr":
        def one(f, fmk, s, smk, w, p, q, p0, q0):
            return jlk.measure_all_corr(world["jctx"], jcfg, f, fmk, s, smk,
                                        w, p, q, p0, q0)
        want = jax.jit(jax.vmap(one))(flat, fm, sharp, sm, sw, pos, quat,
                                      pose0_pos, pose0_quat)
        got = tlk.measure_all_corr(world["tctx"], cfg, t(flat), t(fm),
                                   t(sharp), t(sm), t(sw), t(pos), t(quat),
                                   t(pose0_pos), t(pose0_quat))
    else:
        def one(f, fmk, s, smk, w, p, q):
            return jlk.measure_all(world["jctx"], jcfg, f, fmk, s, smk, w, p,
                                   q)
        want = jax.jit(jax.vmap(one))(flat, fm, sharp, sm, sw, pos, quat)
        got = tlk.measure_all(world["tctx"], cfg, t(flat), t(fm), t(sharp),
                              t(sm), t(sw), t(pos), t(quat))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6)
    assert (np.asarray(want[0]) > 0).any() and (np.asarray(want[1]) > 0.1).any()


def test_measure_likelihood_one_particle_matches_jax(world):
    """The one-particle score the JAX package vmaps, held to JAX's own."""
    center, pos, quat = particles()
    flat, fm, sharp, sm = features(world, center)
    sw = np.random.default_rng(4).uniform(0.5, 2.0, 512).astype(np.float32)
    cfg = config_from(MCL)
    for n in range(3):
        want = jax.jit(lambda p, q: jlk.measure_likelihood(
            world["jctx"], MCL, flat[0], fm[0], sharp[0], sm[0], sw, p, q))(
                pos[0, n], quat[0, n])
        got = tlk.measure_likelihood(
            world["tctx"], cfg, t(flat[0]), t(fm[0]), t(sharp[0]), t(sm[0]),
            t(sw), t(pos[0, n]), t(quat[0, n]))
        assert got[0].shape == () and got[1].shape == ()
        np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(float(got[1]), float(want[1]), atol=1e-6)

# ---------------------------------------------------------------------------
# particle-filter steps with JAX's draws
# ---------------------------------------------------------------------------

def jax_pf(pos, quat, prob, seed=5):
    """A JAX PFState (stacked over robots) with seeded noise coefficients
    and integrals, and the same as the port's."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 0.2, s).astype(np.float32)  # noqa: E731
    st = jpf.PFState(pos=pos, quat=quat, prob=prob,
                     odom_err_integ_lin=f(B, N, 3),
                     odom_err_integ_ang=f(B, N, 3), noise_ll=f(B, N),
                     noise_la=f(B, N), noise_aa=f(B, N), noise_al=f(B, N))
    return st, to_port(st, tpf.PFState, "cpu")


def keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed), B)


def test_init_particles_matches_jax():
    from tools.make_config4_golden import jax_init_normals
    center, _, quat = particles()
    want = jax.vmap(lambda i, p, q: jpf.init_particles(
        jax.random.split(jax.random.PRNGKey(i))[1], MCL, p, q))(
        jnp.arange(B), center, quat[:, 0])
    pos_n, rpy_n = jax_init_normals(0, B, N)
    got = tpf.init_particles(config_from(MCL), t(center), t(quat[:, 0]),
                             t(pos_n), t(rpy_n))
    np.testing.assert_allclose(got.pos.numpy(), np.asarray(want.pos),
                               atol=1e-6)
    np.testing.assert_allclose(got.quat.numpy(), np.asarray(want.quat),
                               atol=1e-6)
    np.testing.assert_array_equal(got.prob.numpy(), np.asarray(want.prob))


def test_pf_steps_match_jax():
    """predict, measure, bias, the biased expectation, the expansion noise,
    the odometry-noise refresh and the covariance."""
    cfg = config_from(MCL)
    _, pos, quat = particles()
    prob = np.random.default_rng(7).random((B, N)).astype(np.float32)
    prob /= prob.sum(1, keepdims=True)
    jst, tst = jax_pf(pos, quat, prob)
    rng = np.random.default_rng(8)
    rel_trans = rng.normal(0, 0.1, (B, 3)).astype(np.float32)
    rel_quat = np.asarray(j_quat_from_rpy(*(rng.normal(0, s, B).astype(
        np.float32) for s in (0.01, 0.01, 0.1))))
    rel_angle = rng.uniform(0, 0.2, B).astype(np.float32)
    like = rng.uniform(0, 3, (B, N)).astype(np.float32)
    like[2] = 0.0                      # a dead cloud keeps its prior
    prev_pos = pos[:, 0] + 0.1
    prev_quat = quat[:, 3]
    sigma = [0.5, 0.5, 0.5, 0.2, 0.2, 0.2]
    dt = np.float32(0.1)

    def jstep(st, rt, rq, ra, lk, pp, pq, k):
        _, k_noise, k_exp = jax.random.split(k, 3)
        st = jpf.predict_diff_drive(st, rt, rq, ra, dt, MCL)
        st = jpf.measure(st, lk)
        bias = jpf.bias_weights(st, pp, pq, MCL)
        e = jpf.expectation_biased(st, bias)
        st = jpf.add_pose_noise(k_exp, st, jnp.asarray(sigma))
        cov = jpf.covariance(st)
        st = jpf.refresh_odom_noise(k_noise, st, MCL)
        return st, bias, e, cov
    k = keys(9)
    want = jax.jit(jax.vmap(jstep))(jst, rel_trans, rel_quat, rel_angle,
                                    like, prev_pos, prev_quat, k)
    # the unit normals those keys give
    exp_n, odom_n = [], []
    for kk in k:
        _, k_noise, k_exp = jax.random.split(kk, 3)
        kp, kr = jax.random.split(k_exp)
        exp_n.append((jax.random.normal(kp, (N, 3)),
                      jax.random.normal(kr, (N, 3))))
        odom_n.append(jnp.stack([jax.random.normal(q, (N,)) for q in
                                 jax.random.split(k_noise, 4)], -1))
    st = tpf.predict_diff_drive(tst, t(rel_trans), t(rel_quat), t(rel_angle),
                                torch.tensor(dt), cfg)
    st = tpf.measure(st, t(like))
    bias = tpf.bias_weights(st, t(prev_pos), t(prev_quat), cfg)
    e = tpf.expectation_biased(st, bias)
    st = tpf.add_pose_noise(st, sigma, t(np.stack([a for a, _ in exp_n])),
                            t(np.stack([b for _, b in exp_n])))
    cov = tpf.covariance(st)
    st = tpf.refresh_odom_noise(st, cfg, t(np.stack(odom_n)))
    wst, wbias, we, wcov = as_np(want)
    for f in tpf.PFState._fields:
        np.testing.assert_allclose(getattr(st, f).numpy(), getattr(wst, f),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(st.prob[2].numpy(), prob[2])
    np.testing.assert_allclose(bias.numpy(), wbias, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(e[0].numpy(), we[0], atol=1e-5)
    np.testing.assert_allclose(e[1].numpy(), we[1], atol=1e-5)
    np.testing.assert_allclose(cov.numpy(), wcov, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("weights", ["random", "boundaries"])
def test_resample_matches_jax(weights):
    """Systematic resampling with JAX's uniform and normals: the same
    source particles (so the same duplicates) and noisy copies within
    1e-6. ``boundaries`` builds weights whose cumulative sums sit within
    an ulp of the scan points, where the cumsum's summation order picks
    the index."""
    _, pos, quat = particles()
    k = keys(11)
    d = jax_mcl_draws(jnp.stack([jax.random.split(kk, 4)[0] for kk in k]), N)
    if weights == "random":
        prob = np.random.default_rng(12).random((B, N)).astype(np.float32)
        prob[:, ::3] *= 0.05                    # many empty slots
        prob /= prob.sum(1, keepdims=True)
    else:
        u = np.stack([np.asarray(jax.random.uniform(
            jax.random.split(jax.random.split(kk, 4)[1])[0], ()))
            for kk in k]).astype(np.float32)
        pstep = np.float32(1.0 / N)
        prob = np.full((B, N), pstep, np.float32)
        prob[:, 0] = u * pstep
        prob[:, -1] = np.float32(1.0) - prob[:, :-1].sum(1)
    jst, tst = jax_pf(pos, quat, prob)
    want = as_np(jax.jit(jax.vmap(lambda kk, s: jpf.resample(
        jax.random.split(kk, 4)[1], s, MCL)))(k, jst))
    # jax_mcl_draws splits a key as mcl_update does: k_res is split 1 of 4
    d = jax_mcl_draws(k, N)
    got = tpf.resample(tst, config_from(MCL), t(d["u"]), t(d["res_pos"]),
                       t(d["res_rpy"]))
    np.testing.assert_array_equal(got.noise_ll.numpy(), want.noise_ll)
    np.testing.assert_array_equal(got.odom_err_integ_lin.numpy(),
                                  want.odom_err_integ_lin)
    np.testing.assert_allclose(got.pos.numpy(), want.pos, atol=1e-6)
    np.testing.assert_allclose(got.quat.numpy(), want.quat, atol=1e-6)
    assert (got.pos.numpy() != jst.pos[np.arange(B)[:, None],
                                       np.zeros((B, N), int)]).any()


@pytest.mark.parametrize("m", [N, 20])
def test_resize_and_helpers_match_jax(m):
    """The global-localization helpers: the deterministic resize (to the
    same and a smaller count, on boundary-prone weights), the seeding of
    one particle per candidate, the most probable particle and the plain
    expectation."""
    _, pos, quat = particles()
    prob = np.random.default_rng(14).random((B, N)).astype(np.float32)
    prob[:, ::4] = 0.0
    prob /= prob.sum(1, keepdims=True)
    jst, tst = jax_pf(pos, quat, prob)
    want = as_np(jax.jit(jax.vmap(lambda s: (
        jpf.resize_particles(s, m), jpf.max_particle(s),
        jpf.expectation(s))))(jst))
    got = (tpf.resize_particles(tst, m), tpf.max_particle(tst),
           tpf.expectation(tst))
    for f in tpf.PFState._fields:
        np.testing.assert_array_equal(getattr(got[0], f).numpy(),
                                      getattr(want[0], f), err_msg=f)
    for g_, w_ in zip(got[1] + got[2], want[1] + want[2]):
        np.testing.assert_allclose(g_.numpy(), w_, atol=1e-6)
    yaws = np.random.default_rng(15).uniform(-3, 3, (B, N)).astype(np.float32)
    want = as_np(jax.vmap(jpf.seed_particles_at)(pos, yaws))
    got = tpf.seed_particles_at(t(pos), t(yaws))
    for f in tpf.PFState._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f),
                                   atol=1e-6, err_msg=f)


# ---------------------------------------------------------------------------
# the update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["corr", "trilinear"])
def test_mcl_update_matches_jax(world, mode):
    """Five updates of three filters on drifting odometry, JAX's draws
    replayed; the feature clouds are those of the true poses."""
    import dataclasses
    jcfg = dataclasses.replace(MCL, field_sampling=mode)
    cfg = config_from(jcfg)
    center, _, quat = particles()
    q0 = quat[:, 0]
    jstate = jax.vmap(lambda i, p, q: jmcl.init_mcl(
        jax.random.PRNGKey(i), jcfg, p, q))(jnp.arange(B), center, q0)
    tstate = to_port(as_np(jstate), tmcl.MCLState, "cpu")
    flat, fm, sharp, sm = features(world, center)
    sw = np.ones((B, 512), np.float32)
    update = jax.jit(jax.vmap(lambda s, pp, pq, op, oq, f, fmk, sp, smk, w:
                              jmcl.mcl_update(jcfg, world["jctx"], s, pp, pq,
                                              op, oq, jnp.float32(0.1), f,
                                              fmk, sp, smk, w)))
    odom_prev_pos, odom_prev_quat = center, q0
    for k in range(5):
        odom_pos = (center + np.float32(0.04 * (k + 1))
                    * np.float32([0.7, 0.7, 0.0])).astype(np.float32)
        odom_quat = q0
        d = jax_mcl_draws(jstate.key, N)
        jstate, jout = update(jstate, odom_prev_pos, odom_prev_quat,
                              odom_pos, odom_quat, flat, fm, sharp, sm, sw)
        tstate, tout = tmcl.mcl_update(
            cfg, world["tctx"], tstate, t(odom_prev_pos), t(odom_prev_quat),
            t(odom_pos), t(odom_quat), torch.tensor(np.float32(0.1)),
            t(flat), t(fm), t(sharp), t(sm), t(sw), port_draws(d, "cpu"))
        jo = as_np(jout)
        for f in ("jumped", "expanded"):
            np.testing.assert_array_equal(getattr(tout, f).numpy(),
                                          getattr(jo, f), err_msg=f"{k} {f}")
        for f in ("pose_pos", "pose_quat", "map2odom_pos", "map2odom_quat",
                  "match_ratio_max"):
            np.testing.assert_allclose(getattr(tout, f).numpy(),
                                       getattr(jo, f), atol=1e-5,
                                       err_msg=f"update {k} {f}")
        np.testing.assert_allclose(tout.covariance.numpy(), jo.covariance,
                                   rtol=1e-3, atol=1e-6)
        jp = as_np(jstate.particles)
        np.testing.assert_allclose(tstate.particles.pos.numpy(), jp.pos,
                                   atol=1e-5, err_msg=f"update {k}")
        # XLA folds the normal's √2 into the noise scale: an ulp apart
        np.testing.assert_allclose(tstate.particles.noise_ll.numpy(),
                                   jp.noise_ll, rtol=1e-6)
        odom_prev_pos, odom_prev_quat = odom_pos, odom_quat
    # the estimates moved with the drifting odometry (the filter did work)
    moved = np.linalg.norm(tout.pose_pos.numpy() - center, axis=1)
    assert (moved > 0.0).all() and np.isfinite(moved).all()


def test_golden_record_helpers_round_trip():
    """``interop.mcl_fields`` of the JAX filter and of its port copy agree,
    ``port_mcl_state`` rebuilds the port's state from such a record, and
    ``port_draws`` keeps ``jax_mcl_draws``' draws in ``MCLDraws``' order."""
    center, _, quat = particles()
    jstate = jax.vmap(lambda i, p, q: jmcl.init_mcl(
        jax.random.PRNGKey(i), MCL, p, q))(jnp.arange(B), center, quat[:, 0])
    tstate = to_port(as_np(jstate), tmcl.MCLState, "cpu")
    jrec, trec = mcl_fields(jstate), mcl_fields(tstate)
    assert jrec.keys() == trec.keys() and len(jrec) == 15
    for k in jrec:
        np.testing.assert_array_equal(trec[k], jrec[k], err_msg=k)
    back = port_mcl_state({k: v[None] for k, v in jrec.items()}, 0, "cpu")
    for k, v in mcl_fields(back).items():
        np.testing.assert_array_equal(v, jrec[k], err_msg=k)
    d = jax_mcl_draws(jstate.key, N)
    draws = port_draws(d, "cpu")
    assert isinstance(draws, tpf.MCLDraws) and len(DRAW_KEYS) == len(draws)
    for k, v in zip(DRAW_KEYS, draws):
        np.testing.assert_array_equal(v.numpy(), d[k], err_msg=k)
    assert draws.resample_u.shape == (B,) and draws.odom.shape == (B, N, 4)


def test_relative_odom_and_motion_gate():
    rng = np.random.default_rng(13)
    p0, p1 = (rng.normal(0, 1, (4, 3)).astype(np.float32) for _ in range(2))
    p1[0] = p0[0] + 0.01                               # under update_min_d
    q0 = np.asarray(j_quat_from_rpy(*(rng.normal(0, 0.3, 4).astype(np.float32)
                                      for _ in range(3))))
    q1 = q0.copy()
    q1[1:] = np.asarray(j_quat_from_rpy(*(rng.normal(0, 0.3, 3).astype(
        np.float32) for _ in range(3))))
    want = jax.jit(jax.vmap(jmcl.relative_odom))(p0, q0, p1, q1)
    got = tmcl.relative_odom(t(p0), t(q0), t(p1), t(q1))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6)
    gate_w = jax.vmap(lambda a, b, c, d: jmcl.motion_gate(MCL, a, b, c, d))(
        p0, q0, p1, q1)
    gate = tmcl.motion_gate(config_from(MCL), t(p0), t(q0), t(p1), t(q1))
    np.testing.assert_array_equal(gate.numpy(), np.asarray(gate_w))
    assert not gate[0] and gate[1:].all()
