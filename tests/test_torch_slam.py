"""The port's SLAM vertical against the JAX package, on the CPU, at
``tests/test_slam.py``'s small size (a 16×250 range image, 32 keyframes)
and in its box world: the rest of ``geometry/se3.py``, the frontend
(projection, ground, segmentation, features, patched ground), the scan
matchers, the pose graph, the mapping session (teacher-forced and
unforced, pause/resume, manual loop, save) and the pose-graph editor.

Tolerances: the frontend exactly (every field, a scan with two points in
one cell included); se3 within 1e-6; each matcher and the pose-graph
solve, from the same inputs, within 1e-5 (metres and quaternion
components; residual and fitness relative); the teacher-forced session
within 1e-5 at every scan with its keyframe, edge and loop integers
exact; the unforced session's integers exact and its last pose within the
JAX test's 0.5 m of the truth (its departure from JAX's poses is printed,
not bounded: one ulp of a scan point moves the JAX run itself by
centimetres).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddmr_navigation_tpu import geometry as jgeo
from dddmr_navigation_tpu.config import SlamConfig
from dddmr_navigation_tpu.slam import editor as jed
from dddmr_navigation_tpu.slam import pipeline as jpipe
from dddmr_navigation_tpu.slam import pose_graph as jpg
from dddmr_navigation_tpu.slam import projection as jproj
from dddmr_navigation_tpu.slam import scan_matching as jsm
from dddmr_navigation_tpu.slam.features import extract_features as j_extract
from dddmr_navigation_tpu.state_estimation.submaps import PoseGraph as JPG
from dddmr_navigation_tpu.utils import BoxWorld, simulate_scan

from dddmr_navigation_tpu_torch import geometry as tgeo
from dddmr_navigation_tpu_torch.interop import (
    config_from, feature_set_fields, keyframe_fields, mapping_fields,
    port_feature_set, port_mapping_state, port_pose_graph, pose_graph_fields)
from dddmr_navigation_tpu_torch.rounding import mean_rows_xla, sum_rows_xla
from dddmr_navigation_tpu_torch.slam import editor as ted
from dddmr_navigation_tpu_torch.slam import pose_graph as tpg
from dddmr_navigation_tpu_torch.slam import projection as tproj
from dddmr_navigation_tpu_torch.slam import scan_matching as tsm
from dddmr_navigation_tpu_torch.slam.features import (
    extract_features as t_extract)
from dddmr_navigation_tpu_torch.slam.pipeline import MappingSession
from dddmr_navigation_tpu_torch.state_estimation.submaps import (
    PoseGraph, read_pose_graph)

torch.set_num_threads(2)

CFG = SlamConfig(num_vertical_scans=16, num_horizontal_scans=250,
                 max_sharp=64, max_less_sharp=256, max_flat=128,
                 max_less_flat=1024, scan_match_iters=10,
                 max_keyframes=32, max_edges=64)
TCFG = config_from(CFG)
WORLD = BoxWorld.room(half=6.0).add_box([2.0, -1.0, 0], [2.6, 1.0, 1.8])
TOL = 1e-5


def t(x):
    return torch.tensor(np.array(x))


def _scan(pos, yaw=0.0):
    return simulate_scan(WORLD, pos, yaw, n_rings=16, n_cols=250)


def _path(n, step=0.45, dyaw=0.06):
    """``test_mapping_session_end_to_end``'s drive: from (-3, -3), 0.45 m
    a scan turning 0.06 rad a scan."""
    pos, yaw, out = np.array([-3.0, -3.0, 0.8], np.float32), 0.0, []
    for _ in range(n):
        out.append((pos.copy(), yaw))
        pos = pos + np.array([step * np.cos(yaw), step * np.sin(yaw), 0.0],
                             np.float32)
        yaw += dyaw
    return out


_j_frontend = jax.jit(lambda p, m: (lambda img: (img, j_extract(CFG, img)))(
    jproj.project(CFG, p, m)))


def _j_feats(pos, yaw):
    return _j_frontend(*_scan(pos, yaw))[1]


def _port(jf):
    return port_feature_set(feature_set_fields(jf), "cpu")


def _diff(a, b):
    return float(np.abs(np.asarray(a) - b.detach().numpy()).max())


# ---------------------------------------------------------------------------
# se3
# ---------------------------------------------------------------------------

def _quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _vecs(n, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, 3))
            * scale).astype(np.float32)


SE3_CASES = {
    "quat_identity": (lambda g: g.quat_identity(), lambda g: g.quat_identity(
        device="cpu")),
    "quat_inverse_rotate": lambda g, q, v: g.quat_inverse_rotate(q, v),
    "quat_exp": lambda g, q, v: g.quat_exp(v * 0.3),
    "quat_exp_zero": lambda g, q, v: g.quat_exp(v * 0.0),
    "quat_to_matrix": lambda g, q, v: g.quat_to_matrix(q),
    "matrix_to_quat": lambda g, q, v: g.matrix_to_quat(g.quat_to_matrix(q)),
    "se3_identity": (lambda g: g.se3_identity(), lambda g: g.se3_identity(
        device="cpu")),
    "se3_from_xyzq": lambda g, q, v: g.se3_from_xyzq(v[:, 0], v[:, 1],
                                                     v[:, 2], q),
    "se3_compose": lambda g, q, v: g.se3_compose((v[:16], q[:16]),
                                                 (v[16:], q[16:])),
    "se3_inverse": lambda g, q, v: g.se3_inverse((v, q)),
    "se3_apply": lambda g, q, v: g.se3_apply((v[:4], q[:4]),
                                             v.reshape(4, 8, 3)),
}


@pytest.mark.parametrize("name", sorted(SE3_CASES))
def test_se3_matches_jax(name):
    """Each function the port adds to ``geometry/se3.py`` against the JAX
    one on the same inputs, within 1e-6."""
    case = SE3_CASES[name]
    if isinstance(case, tuple):
        got, want = case[1](tgeo), case[0](jgeo)
    else:
        q, v = _quats(32, 1), _vecs(32, 2, 3.0)
        want = case(jgeo, jnp.asarray(q), jnp.asarray(v))
        got = case(tgeo, t(q), t(v))
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)
                    if not isinstance(got, torch.Tensor) else [got]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=0)


def test_se3_properties():
    """``tests/test_geometry.py``'s properties on the port: the matrix
    rotates as ``quat_rotate``, matrix → quat round-trips (up to sign),
    compose with the inverse is the identity, ``se3_apply`` is R·p + t,
    and ``quat_exp`` has a finite derivative at 0."""
    q, v = t(_quats(64, 7)), t(_vecs(64, 1))
    m = tgeo.quat_to_matrix(q)
    np.testing.assert_allclose(torch.einsum("nij,nj->ni", m, v).numpy(),
                               tgeo.quat_rotate(q, v).numpy(), atol=1e-5)
    dot = (tgeo.matrix_to_quat(m) * q).sum(-1).abs()
    np.testing.assert_allclose(dot.numpy(), 1.0, atol=1e-4)
    ts = t(_vecs(64, 9))
    p2, q2 = tgeo.se3_compose((ts, q), tgeo.se3_inverse((ts, q)))
    np.testing.assert_allclose(p2.numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(q2[:, 3].abs().numpy(), 1.0, atol=1e-5)
    pts = t(_vecs(64, 3)).reshape(8, 8, 3)
    got = tgeo.se3_apply((ts[:8], q[:8]), pts)
    want = torch.einsum("bij,bpj->bpi", m[:8], pts) + ts[:8, None]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    jac = torch.func.jacfwd(tgeo.quat_exp)(torch.zeros(3))
    assert torch.isfinite(jac).all()
    np.testing.assert_allclose(jac[:3].numpy(), 0.5 * np.eye(3), atol=1e-7)


# ---------------------------------------------------------------------------
# XLA-on-the-CPU reductions the matchers reproduce
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [5, 33, 256, 576, 1000, 2048, 2560, 4096])
def test_sum_rows_matches_xla(n):
    """``rounding.sum_rows_xla``/``mean_rows_xla`` equal jitted
    ``jnp.sum``/``jnp.mean`` over axis 0 bit for bit, and a 1e6-padded
    submap's mean too (the recentring the squared distances cancel to)."""
    x = (np.random.default_rng(n).normal(size=(n, 3)) * 3 + 5).astype(
        np.float32)
    x[n // 3:] = np.where(np.arange(n - n // 3)[:, None] % 3 == 0, 1e6,
                          x[n // 3:])
    np.testing.assert_array_equal(
        sum_rows_xla(t(x)).numpy(), np.asarray(jax.jit(
            lambda a: jnp.sum(a, axis=0))(x)))
    np.testing.assert_array_equal(
        mean_rows_xla(t(x)).numpy(), np.asarray(jax.jit(
            lambda a: jnp.mean(a, axis=0))(x)))


def test_solve3_matches_jax():
    """The plane fit's 3 × 3 solve equals ``jnp.linalg.solve`` bit for
    bit, on random systems and on the nearly singular ones of five
    clustered points."""
    rng = np.random.default_rng(0)
    ctr = rng.normal(size=(4000, 1, 3)) * 4
    pts = (ctr + rng.normal(size=(4000, 5, 3)) * 0.05).astype(np.float32)
    a_c = np.einsum("nki,nkj->nij", pts, pts).astype(np.float32) \
        + np.float32(1e-6) * np.eye(3, dtype=np.float32)
    b_c = -pts.sum(1).astype(np.float32)
    a_r = rng.normal(size=(4000, 3, 3)).astype(np.float32)
    b_r = rng.normal(size=(4000, 3)).astype(np.float32)
    solve = jax.jit(lambda a, b: jnp.linalg.solve(a, b[:, :, None])[:, :, 0])
    for a, b in ((a_c, b_c), (a_r, b_r)):
        np.testing.assert_array_equal(tsm._solve3(t(a), t(b)).numpy(),
                                      np.asarray(solve(a, b)))


# ---------------------------------------------------------------------------
# frontend: exact
# ---------------------------------------------------------------------------

def _frontend_equal(pts, mask):
    jimg, jf = _j_frontend(pts, mask)
    timg = tproj.project(TCFG, t(pts), t(mask))
    tf = t_extract(TCFG, timg)
    for name, a, b in list(zip(jimg._fields, jimg, timg)) + list(
            zip(jf._fields, jf, tf)):
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    return jimg, timg


@pytest.mark.parametrize("k", [0, 3, 6, 9])
def test_frontend_exact_on_the_drive(k):
    """Scans of the mapping fixture's drive: every ``RangeImage`` and
    ``FeatureSet`` field (rings, masks, ``less_flat_ground``) equals the
    jitted JAX frontend's."""
    pos, yaw = _path(10)[k]
    _frontend_equal(*_scan(pos, yaw))


def test_frontend_exact_with_duplicate_cells():
    """Points that fall into one image cell: the last one wins, as XLA's
    in-order scatter on the CPU leaves it."""
    pts, mask = _scan([0.3, -0.2, 0.8], 0.4)
    rng = np.random.default_rng(5)
    src = rng.choice(np.nonzero(mask)[0], 200, replace=False)
    extra = pts[src] * np.float32(1.0 + 1e-4) + np.float32(1e-3)
    pts = np.concatenate([pts, extra]).astype(np.float32)
    mask = np.concatenate([mask, np.ones(len(src), bool)])
    jimg, _ = _frontend_equal(pts, mask)
    # fewer pixels than points: cells were shared; the appended points
    # (each a near copy of an earlier one) took their cells
    img = np.asarray(jimg.pts)[np.asarray(jimg.valid)]
    assert len(img) < mask.sum() - 150
    won = (extra[:, None, :] == img[None, :, :]).all(-1).any(-1)
    assert won.sum() > 150, won.sum()


@pytest.mark.parametrize("first_frame", [True, False])
def test_patched_ground_exact(first_frame):
    """The eager projection equals the JAX package's eager ``project``
    (the keyframe's patched-ground image), and ``patched_ground_points``
    of it equals JAX's, cloud for cloud."""
    pts, mask = _scan([0.0, 0.0, 0.8], 0.2)
    jimg = jproj.project(CFG, jnp.asarray(pts), jnp.asarray(mask))
    timg = tproj.project(TCFG, t(pts), t(mask), eager=True)
    for name, a, b in zip(jimg._fields, jimg, timg):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=name)
    jg = jproj.patched_ground_points(CFG, jimg.pts, jimg.valid, jimg.ground,
                                     first_frame=first_frame)
    tg = tproj.patched_ground_points(TCFG, timg.pts, timg.valid, timg.ground,
                                     first_frame=first_frame)
    for a, b in zip(jg, tg):
        np.testing.assert_array_equal(b, a)
        assert len(b) > 50


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pair():
    """Features of two scans 0.4 m and 0.12 rad apart (JAX's), and an
    initial guess off the truth."""
    f0 = _j_feats([0.0, 0.0, 0.8], 0.0)
    f1 = _j_feats([0.4, 0.05, 0.8], 0.12)
    q = np.array([0, 0, 0.05, 0.99875], np.float32)
    return f0, f1, np.array([0.3, 0, 0], np.float32), q / np.linalg.norm(q)


def _close(want, got, name):
    (jp, jq, jr), (tp, tq, tr) = want, got
    assert _diff(jp, tp) <= TOL and _diff(jq, tq) <= TOL, name
    assert abs(float(tr) - float(jr)) <= TOL * max(1.0, abs(float(jr))), name


@pytest.mark.parametrize("rings", [True, False])
def test_match_scans_matches_jax(pair, rings):
    f0, f1, ip, iq = pair
    fa, fb = _port(f0), _port(f1)

    def args(a, b, pkg):
        kw = (dict(tgt_less_sharp_ring=a.less_sharp_ring,
                   tgt_less_flat_ring=a.less_flat_ring) if rings else {})
        return ((b.sharp, b.sharp_mask, b.less_flat[::4],
                 b.less_flat_mask[::4], a.less_sharp, a.less_sharp_mask,
                 a.less_flat, a.less_flat_mask), kw)
    ja, jkw = args(f0, f1, jnp)
    want = jax.jit(lambda p, q: jsm.match_scans(
        CFG, *ja, init_pos=p, init_quat=q, **jkw))(ip, iq)
    ta, tkw = args(fa, fb, torch)
    got = tsm.match_scans(TCFG, *ta, init_pos=t(ip), init_quat=t(iq), **tkw)
    _close(want, got, f"rings={rings}")
    assert float(np.linalg.norm(np.asarray(want[0]) - [0.4, 0.05, 0])) < 0.1


def _submap(f, n_sharp=512, n_flat=2048, keep_sharp=None):
    def pad(x, m, n, keep):
        x = np.asarray(x)[np.asarray(m)][:keep]
        out = np.full((n, 3), 1e6, np.float32)
        out[:len(x)] = x
        mm = np.zeros(n, bool)
        mm[:len(x)] = True
        return out, mm
    return (*pad(f.less_sharp, f.less_sharp_mask, n_sharp, keep_sharp),
            *pad(f.less_flat, f.less_flat_mask, n_flat, None))


@pytest.mark.parametrize("keep_sharp", [None, 3])
def test_match_to_map_matches_jax(pair, keep_sharp):
    """Against a 1e6-padded submap (the session's), where the squared
    distances cancel down to the target mean's rounding; and with fewer
    valid submap corners than the 5 neighbours (the padding is gathered,
    no residual turns NaN)."""
    f0, f1, ip, iq = pair
    sub = _submap(f0, keep_sharp=keep_sharp)
    fn = jax.jit(lambda a, p, q, *s: jsm.match_to_map(
        CFG, a.sharp, a.sharp_mask, a.less_flat[::4], a.less_flat_mask[::4],
        *s, init_pos=p, init_quat=q, iters=6))
    want = fn(f1, ip, iq, *sub)
    fb = _port(f1)
    got = tsm.match_to_map(TCFG, fb.sharp, fb.sharp_mask, fb.less_flat[::4],
                           fb.less_flat_mask[::4], *map(t, sub),
                           init_pos=t(ip), init_quat=t(iq), iters=6)
    assert all(torch.isfinite(x).all() for x in got)
    _close(want, got, f"keep_sharp={keep_sharp}")


def test_icp_matches_jax(pair):
    f0, f1, ip, iq = pair
    src = np.concatenate([np.asarray(f1.less_flat), np.asarray(f1.less_sharp)])
    sm = np.concatenate([np.asarray(f1.less_flat_mask),
                         np.asarray(f1.less_sharp_mask)])
    tgt = np.concatenate([np.asarray(f0.less_flat), np.asarray(f0.less_sharp)])
    tm = np.concatenate([np.asarray(f0.less_flat_mask),
                         np.asarray(f0.less_sharp_mask)])
    want = jsm.icp_point2point(src, sm, tgt, tm, 30, 2.0, ip, iq)
    got = tsm.icp_point2point(t(src), t(sm), t(tgt), t(tm), 30, 2.0, t(ip),
                              t(iq))
    _close(want, got, "icp")
    assert float(want[2]) < CFG.history_keyframe_fitness_score


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------

def _square_graph(pkg, g):
    """``tests/test_slam.py:124``'s drifted square with a loop edge, built
    through ``pkg``'s add_node/add_edge (numpy inputs)."""
    true = [(0, 0), (3, 0), (3, 3), (0, 3)]
    yaw = [0.0, np.pi / 2, np.pi, -np.pi / 2]
    q = [np.asarray(jgeo.quat_from_yaw(jnp.float32(y))) for y in yaw]
    drift = np.array([0.25, -0.2, 0.0], np.float32)
    est = [np.zeros(3, np.float32)] + [
        np.asarray([true[i][0], true[i][1], 0.0], np.float32) + drift * i / 3
        for i in range(1, 4)]
    for i in range(4):
        g = pkg.add_node(g, i, est[i], q[i])

    def rel(i, j, pi, pj):
        qi = jnp.asarray(q[i])
        rq = np.asarray(jgeo.quat_multiply(jgeo.quat_conjugate(qi),
                                           jnp.asarray(q[j])))
        rp = np.asarray(jgeo.quat_rotate(jgeo.quat_conjugate(qi),
                                         jnp.asarray(pj - pi)))
        return rp, rq
    # odometry edges from the drifted estimates, the loop edge 3 → 0 from
    # the truth, weighted 10
    for e, (i, j) in enumerate([(0, 1), (1, 2), (2, 3)]):
        g = pkg.add_edge(g, e, i, j, *rel(i, j, est[i], est[j]))
    g = pkg.add_edge(g, 3, 3, 0, *rel(3, 0, np.float32([0, 3, 0]),
                                      np.zeros(3, np.float32)), weight=10.0)
    return g


def _random_graph(pkg, g, seed=0, n=20):
    """20 nodes of a 32-node graph (12 padded), a drifted chain plus
    random edges from the truth."""
    rng = np.random.default_rng(seed)
    true_p = np.cumsum(rng.normal(size=(n, 3)) * [1, 1, 0.05], 0).astype(
        np.float32)
    true_y = np.cumsum(rng.normal(size=n) * 0.3)

    def yq(y):
        return np.asarray(jgeo.quat_from_yaw(jnp.float32(y)))
    for i in range(n):
        p = (true_p[i] + rng.normal(size=3) * 0.2 * (i > 0)).astype(
            np.float32)
        g = pkg.add_node(g, i, p, yq(true_y[i] + rng.normal() * 0.05
                                     * (i > 0)))
    pairs = [(i, i + 1) for i in range(n - 1)] + [
        (int(a), int(b)) for a, b in rng.integers(0, n, (10, 2)) if a != b]
    for e, (i, j) in enumerate(pairs):
        qi = jnp.asarray(yq(true_y[i]))
        rq = np.asarray(jgeo.quat_multiply(jgeo.quat_conjugate(qi),
                                           jnp.asarray(yq(true_y[j]))))
        rp = np.asarray(jgeo.quat_rotate(jgeo.quat_conjugate(qi), jnp.asarray(
            true_p[j] - true_p[i]))) + rng.normal(size=3).astype(
            np.float32) * 0.02
        g = pkg.add_edge(g, e, i, j, rp, rq, float(rng.uniform(0.5, 5)))
    return g


@pytest.mark.parametrize("case", ["square", "random32"])
def test_optimize_pose_graph_matches_jax(case):
    build, k, e, iters = ((_square_graph, 16, 32, 10) if case == "square"
                          else (_random_graph, 32, 64, 8))
    jg = build(jpg, jpg.empty_graph(k, e))
    tg = build(tpg, tpg.empty_graph(k, e, "cpu"))
    for name in jpg.PoseGraphArrays._fields:
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)), name)
    want = jpg.optimize_pose_graph(jg, iters)
    got = tpg.optimize_pose_graph(tg, iters)
    assert _diff(want.pos, got.pos) <= TOL
    assert _diff(want.quat, got.quat) <= TOL
    assert _diff(jg.pos, got.pos) > 0.01          # the solve moved them
    np.testing.assert_array_equal(got.pos[k - 1].numpy(), 0.0)   # padding


def test_detect_loop_candidate_exact():
    """``tests/test_slam.py``'s 40-keyframe circle: candidate index and
    found flag exact at several keyframes, radii and gaps."""
    jg, tg = jpg.empty_graph(64, 8), tpg.empty_graph(64, 8, "cpu")
    for i in range(40):
        ang = 2 * np.pi * i / 40
        p = np.asarray([5 * np.cos(ang) - 5, 5 * np.sin(ang), 0.0],
                       np.float32)
        q = np.asarray([0, 0, 0, 1], np.float32)
        jg, tg = jpg.add_node(jg, i, p, q), tpg.add_node(tg, i, p, q)
    for cur, radius, gap in ((39, 2.0, 20), (30, 2.0, 20), (25, 9.0, 5),
                             (39, 0.5, 20)):
        ji, jf = jpg.detect_loop_candidate(jg, cur, radius, gap)
        ti, tf = tpg.detect_loop_candidate(tg, cur, radius, gap)
        assert (int(ti), bool(tf)) == (int(ji), bool(jf))


def test_graph_record_round_trip():
    """``interop.pose_graph_fields``/``port_pose_graph`` and the feature
    set's carry every array across unchanged."""
    jg = _random_graph(jpg, jpg.empty_graph(32, 64))
    back = port_pose_graph(pose_graph_fields(jg), "cpu")
    for name in jpg.PoseGraphArrays._fields:
        np.testing.assert_array_equal(getattr(back, name).numpy(),
                                      np.asarray(getattr(jg, name)))
    jf = _j_feats([0.0, 0.0, 0.8], 0.0)
    for a, b in zip(jf, _port(jf)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------------------
# the mapping session
# ---------------------------------------------------------------------------

SCANS = 10


@pytest.fixture(scope="module")
def mapping_runs():
    """The JAX session over the drive, the port's teacher-forced on JAX's
    state at each scan, and the port's unforced."""
    js = jpipe.MappingSession(cfg=CFG)
    ts = MappingSession(cfg=TCFG, device="cpu")
    forced, jax_out, free_out = [], [], []
    for pos, yaw in _path(SCANS):
        pts, mask = _scan(pos, yaw)
        state = mapping_fields(js)
        sess = port_mapping_state(state, TCFG, "cpu")
        rebuilt = port_mapping_state(
            {k: v for k, v in state.items() if not k.startswith("submap_")},
            TCFG, "cpu")
        jp, jq = js.process_scan(pts, mask)
        fp, fq = sess.process_scan(pts, mask)
        up, uq = ts.process_scan(pts, mask)
        forced.append(dict(pos=fp, quat=fq, kf=sess.n_keyframes,
                           edges=sess.n_edges,
                           loops=len(sess.loop_closures),
                           submap_state=state, rebuilt=rebuilt._submap))
        jax_out.append(dict(pos=np.asarray(jp), quat=np.asarray(jq),
                            kf=js.n_keyframes, edges=js.n_edges,
                            loops=len(js.loop_closures)))
        free_out.append(dict(pos=up, quat=uq, kf=ts.n_keyframes,
                             edges=ts.n_edges, loops=len(ts.loop_closures)))
    return js, ts, forced, jax_out, free_out


def test_mapping_teacher_forced_matches_jax(mapping_runs):
    """From JAX's state before each scan: the scan's pose within 1e-5, its
    keyframe, edge and loop counts exact."""
    _, _, forced, jax_out, _ = mapping_runs
    for k, (f, j) in enumerate(zip(forced, jax_out)):
        assert np.abs(f["pos"] - j["pos"]).max() <= TOL, k
        assert np.abs(f["quat"] - j["quat"]).max() <= TOL, k
        assert (f["kf"], f["edges"], f["loops"]) == (
            j["kf"], j["edges"], j["loops"]), k
    assert jax_out[-1]["kf"] >= 3


def test_mapping_submap_rebuild_exact(mapping_runs):
    """The submap the port rebuilds from a state (keyframes and graph
    poses; ``interop.port_mapping_state`` without ``submap_*``) equals the
    JAX session's, bit for bit, at every scan."""
    _, _, forced, _, _ = mapping_runs
    seen = 0
    for k, f in enumerate(forced):
        state, rebuilt = f["submap_state"], f["rebuilt"]
        if "submap_sharp" not in state:
            assert rebuilt is None, k
            continue
        seen += 1
        for name, b in zip(("submap_sharp", "submap_sharp_m", "submap_flat",
                            "submap_flat_m"), rebuilt):
            np.testing.assert_array_equal(b.numpy(), state[name],
                                          err_msg=f"scan {k} {name}")
    assert seen >= SCANS - 1


def test_mapping_unforced_integers_and_truth(mapping_runs):
    """Closed loop: keyframe, edge and loop counts equal JAX's at every
    scan; the last pose within the JAX test's 0.5 m of the truth."""
    js, ts, _, jax_out, free_out = mapping_runs
    for k, (u, j) in enumerate(zip(free_out, jax_out)):
        assert (u["kf"], u["edges"], u["loops"]) == (
            j["kf"], j["edges"], j["loops"]), k
    dep = max(float(np.abs(u["pos"] - j["pos"]).max())
              for u, j in zip(free_out, jax_out))
    print(f"unforced session: largest departure from JAX's poses {dep!r} m")
    tp, _ = _path(SCANS)[-1]
    err = np.linalg.norm(free_out[-1]["pos"][:2] - (tp[:2] - [-3.0, -3.0]))
    assert err < 0.5, err


def test_mapping_save_matches_jax(mapping_runs, tmp_path):
    """``save`` of the same state: the port's files read back (the port's
    ``read_pose_graph``) equal to JAX's save."""
    js, _, _, _, _ = mapping_runs
    sess = port_mapping_state(mapping_fields(js), TCFG, "cpu")
    js.save(str(tmp_path / "j"))
    sess.save(str(tmp_path / "t"))
    a, b = read_pose_graph(str(tmp_path / "j")), read_pose_graph(
        str(tmp_path / "t"))
    np.testing.assert_array_equal(b.poses, a.poses)
    assert len(a.feature_clouds) == js.n_keyframes
    for x, y in zip(a.feature_clouds + a.ground_clouds,
                    b.feature_clouds + b.ground_clouds):
        np.testing.assert_array_equal(y, x)


def test_mapping_record_round_trip(mapping_runs):
    """``mapping_fields`` of the port's session read back through
    ``port_mapping_state`` gives the same fields."""
    _, ts, _, _, _ = mapping_runs
    f = mapping_fields(ts)
    back = mapping_fields(port_mapping_state(f, TCFG, "cpu"))
    assert sorted(f) == sorted(back)
    for k in f:
        np.testing.assert_array_equal(back[k], f[k], err_msg=k)
    assert set(keyframe_fields(ts)) <= set(f)


def test_mapping_pause_resume():
    """``test_mapping_pause_resume`` on the port: paused scans change
    nothing, mapping continues after resume."""
    sess = MappingSession(cfg=TCFG, device="cpu")
    pos = np.array([-3.0, -3.0, 0.8], np.float32)
    for _ in range(3):
        sess.process_scan(*_scan(pos))
        pos = pos + np.array([0.5, 0.0, 0.0], np.float32)
    kf, p_before = sess.n_keyframes, sess.cur_pos.copy()
    sess.pause()
    for _ in range(2):
        sess.process_scan(*_scan(pos))
        pos = pos + np.array([0.5, 0.0, 0.0], np.float32)
    assert sess.n_keyframes == kf
    np.testing.assert_array_equal(sess.cur_pos, p_before)
    sess.resume()
    sess.process_scan(*_scan(pos))
    assert not np.array_equal(sess.cur_pos, p_before)


def test_manual_loop_matches_jax(mapping_runs):
    """``manual_loop(0, last)`` from the same state: accepted in both, the
    fitness and the re-optimized poses within 1e-5, one more edge and loop;
    a strict gate rejects and adds nothing."""
    js, _, _, _, _ = mapping_runs
    state = mapping_fields(js)
    sess = port_mapping_state(state, TCFG, "cpu")
    j2 = jpipe.MappingSession(cfg=CFG)
    for name in ("cur_pos", "cur_quat", "keyframe_feats", "keyframe_ground",
                 "keyframe_ground_edge", "n_keyframes", "n_edges", "graph",
                 "_submap"):
        setattr(j2, name, getattr(js, name))
    j2.loop_closures = list(js.loop_closures)
    last = js.n_keyframes - 1
    ja, jfit = j2.manual_loop(0, last)
    ta, tfit = sess.manual_loop(0, last)
    assert ja and ta
    assert abs(tfit - jfit) <= TOL * max(1.0, jfit)
    assert sess.n_edges == js.n_edges + 1 == j2.n_edges
    assert _diff(j2.graph.pos, sess.graph.pos) <= TOL
    assert np.abs(sess.cur_pos - j2.cur_pos).max() <= TOL
    rejected, _ = sess.manual_loop(0, last, fitness_gate=-1.0)
    assert not rejected and sess.n_edges == js.n_edges + 1


# ---------------------------------------------------------------------------
# the pose-graph editor
# ---------------------------------------------------------------------------

def _line_graph(cls, k=6, drift=0.05, n_pts=256, seed=0):
    """``tests/test_editor.py``'s drifted line of keyframes over one
    world cloud, as ``cls`` (either package's PoseGraph)."""
    rng = np.random.default_rng(seed)
    world = rng.uniform(-4, 4, (n_pts, 3)).astype(np.float32)
    poses = np.zeros((k, 8), np.float32)
    feats, grounds = [], []
    for i in range(k):
        true_p = np.array([1.0 * i, 0.0, 0.0], np.float32)
        poses[i, :3] = true_p + np.array([0.0, drift * i, 0.0], np.float32)
        feats.append(world - true_p[None, :])
        grounds.append((world - true_p[None, :]) * np.float32(0.5))
    return cls(poses=poses, feature_clouds=feats, ground_clouds=grounds)


def _editors(**kw):
    return (jed.GraphEditor.from_graph(_line_graph(JPG, **kw)),
            ted.GraphEditor.from_graph(_line_graph(PoseGraph, **kw),
                                       device="cpu"))


def _edges_close(je, te):
    assert len(je.edges) == len(te.edges)
    for a, b in zip(je.edges, te.edges):
        assert (a["i"], a["j"], a["kind"]) == (b["i"], b["j"], b["kind"])
        np.testing.assert_allclose(b["rel_pos"], np.asarray(a["rel_pos"]),
                                   atol=TOL)
        np.testing.assert_allclose(b["rel_quat"], np.asarray(a["rel_quat"]),
                                   atol=TOL)
        assert abs(b["weight"] - a["weight"]) <= TOL * max(1.0, a["weight"])


def test_editor_delete_edge_matches_jax():
    je, te = _editors()
    _edges_close(je, te)
    assert je.delete_edge(2, 3) and te.delete_edge(2, 3)
    assert not te.delete_edge(2, 3)
    _edges_close(je, te)


def test_editor_icp_edge_and_optimize_match_jax():
    je, te = _editors(k=6, drift=0.06)
    jfit, tfit = je.add_icp_edge(0, 5), te.add_icp_edge(0, 5)
    assert tfit < 1e-2 and abs(tfit - jfit) <= TOL
    nudge = np.array([0.05, -0.05, 0.0, 0.0, 0.0, 0.05], np.float32)
    jfit2 = je.add_icp_edge(1, 4, init_nudge=nudge)
    tfit2 = te.add_icp_edge(1, 4, init_nudge=nudge)
    assert abs(tfit2 - jfit2) <= TOL
    je.edges[-2]["weight"] = te.edges[-2]["weight"] = 50.0
    _edges_close(je, te)
    err_before = abs(te.graph.poses[5, 1])
    je.optimize(iters=10)
    te.optimize(iters=10)
    np.testing.assert_allclose(te.graph.poses, je.graph.poses, atol=TOL)
    assert abs(te.graph.poses[5, 1]) < 0.5 * err_before


def test_editor_rigid_ops_match_jax():
    je, te = _editors(k=4, drift=0.0)
    for ed in (je, te):
        ed.translate([1.0, -2.0, 0.5])
        ed.rotate_yaw(np.pi / 2, about=(1.0, -2.0, 0.5))
    np.testing.assert_array_equal(te.graph.poses, je.graph.poses)
    np.testing.assert_allclose(te.graph.poses[1, :3], [1.0, -1.0, 0.5],
                               atol=1e-5)


def test_editor_merge_save_load_round_trip(tmp_path):
    """Merge two sessions, add a loop edge, save; each package loads the
    other's files to the same editor."""
    je, te = _editors(k=3, drift=0.0, seed=1)
    je.merge(_line_graph(JPG, k=3, drift=0.0, seed=1), connect=(0, 1))
    te.merge(_line_graph(PoseGraph, k=3, drift=0.0, seed=1), connect=(0, 1))
    _edges_close(je, te)
    assert sum(e["kind"] == "odom" for e in te.edges) == 4
    je.save(str(tmp_path / "j"))
    te.save(str(tmp_path / "t"))
    for d in ("j", "t"):
        jl = jed.GraphEditor.load(str(tmp_path / d))
        tl = ted.GraphEditor.load(str(tmp_path / d), device="cpu")
        np.testing.assert_array_equal(tl.graph.poses, jl.graph.poses)
        _edges_close(jl, tl)
        assert sum(e["kind"] == "loop" for e in tl.edges) == 1
    a, b = read_pose_graph(str(tmp_path / "j")), read_pose_graph(
        str(tmp_path / "t"))
    np.testing.assert_allclose(b.poses, a.poses, atol=TOL)
    np.testing.assert_array_equal(b.edges, a.edges)
