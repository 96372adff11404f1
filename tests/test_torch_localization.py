"""The port's localization vertical against the JAX package, on the CPU:
pose-graph files and submap stitching, the submap manager's prefetch,
odom3d, the feature-weight preprocessing, the particle resize and the
global-localization seed and chain (the inputs of
``tests/test_state_estimation.py:364-565``).

Tolerances: exact for stitched point counts, keep masks, kNN indices,
cluster labels, particle counts and fix countdowns, and for the seed's
positions; odom3d within 1e-6 m; normals within 1e-5; weights within
1e-6; the global-localization estimates and particles within the fleet's
rtol 2e-6 (atol 1e-6), its map→odom LPF states within atol 2e-5.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddmr_navigation_tpu.config import MCLConfig as JMCLConfig
from dddmr_navigation_tpu.geometry import quat_from_rpy as j_quat_from_rpy
from dddmr_navigation_tpu.state_estimation import feature_weights as jfw
from dddmr_navigation_tpu.state_estimation import odom3d as jodom
from dddmr_navigation_tpu.state_estimation import pf as jpf
from dddmr_navigation_tpu.state_estimation import submaps as jsub

from dddmr_navigation_tpu_torch import entry
from dddmr_navigation_tpu_torch.interop import (
    config_from, mcl_fields, port_seed_draws, port_tick_of_one)
from dddmr_navigation_tpu_torch.state_estimation import feature_weights as tfw
from dddmr_navigation_tpu_torch.state_estimation import odom3d as todom
from dddmr_navigation_tpu_torch.state_estimation import pf as tpf
from dddmr_navigation_tpu_torch.state_estimation import submaps as tsub
from dddmr_navigation_tpu_torch.state_estimation.global_localization import (
    draw_seed, seed_global_state)
from dddmr_navigation_tpu_torch.state_estimation.likelihood import (
    build_submap_context)

torch.set_num_threads(2)

CFG = JMCLConfig()


def t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# pose-graph files, stitching and the submap manager
# ---------------------------------------------------------------------------

def _graph(k=3, seed=0):
    rng = np.random.default_rng(seed)
    poses = np.zeros((k, 8), np.float32)
    poses[:, 0] = 2.0 * np.arange(k)
    poses[:, 6] = 0.3 * np.arange(k)  # yaw
    feats = [rng.normal(0, 1, (20, 3)).astype(np.float32) for _ in range(k)]
    grounds = [rng.normal(0, 1, (15, 3)).astype(np.float32)
               for _ in range(k)]
    return poses, feats, grounds


def test_pose_graph_roundtrip_matches_jax(tmp_path):
    """The JAX test's pose graph written by the port reads back equal
    through both packages, and stitches the same clouds; a graph written
    by the JAX package reads back equal through the port."""
    poses, feats, grounds = _graph()
    tsub.write_pose_graph(str(tmp_path / "port"),
                          tsub.PoseGraph(poses, feats, grounds))
    jsub.write_pose_graph(str(tmp_path / "jax"),
                          jsub.PoseGraph(poses, feats, grounds))
    for src in ("port", "jax"):
        mine = tsub.read_pose_graph(str(tmp_path / src))
        ref = jsub.read_pose_graph(str(tmp_path / src))
        np.testing.assert_array_equal(mine.poses, ref.poses)
        np.testing.assert_allclose(mine.poses[:, :8], poses, atol=1e-5)
        for a, b in zip(mine.feature_clouds + mine.ground_clouds,
                        ref.feature_clouds + ref.ground_clouds):
            np.testing.assert_array_equal(a, b)
        for radius, counts in ((3.0, (40, 30)), (0.5, (20, 15)),
                               (10.0, (60, 45))):
            m, g = tsub.stitch_submap(mine, [0, 0, 0], radius=radius)
            jm, jg = jsub.stitch_submap(ref, [0, 0, 0], radius=radius)
            assert (len(m), len(g)) == counts
            np.testing.assert_array_equal(m, jm)
            np.testing.assert_array_equal(g, jg)
    # the stitched global clouds the writers add are equal too
    for name in ("map.pcd", "ground.pcd"):
        from dddmr_navigation_tpu_torch.io import read_pcd
        np.testing.assert_array_equal(read_pcd(str(tmp_path / "port" / name)),
                                      read_pcd(str(tmp_path / "jax" / name)))


def _ctx_equal(a, b):
    for fa, fb in ((a.map_field, b.map_field), (a.ground_field,
                                                 b.ground_field)):
        assert fa.res == fb.res
        for f in ("dist", "origin", "packed", "near_pt"):
            assert torch.equal(getattr(fa, f).cpu(), getattr(fb, f).cpu()), f
    for f in ("ground_normal", "ground_count", "ground_xy_origin"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()), f
    assert a.ground_xy_res == b.ground_xy_res


def test_submap_manager_builds_and_swaps(tmp_path):
    """``initialize`` builds the context ``build_submap_context`` gives
    from the stitched clouds; a drift past the trigger prefetches on the
    thread, and the next ``current`` swaps in the complete context of the
    new center (the thread joined with a timeout)."""
    poses, feats, grounds = _graph(k=6, seed=1)
    tsub.write_pose_graph(str(tmp_path), tsub.PoseGraph(poses, feats,
                                                        grounds))
    graph = tsub.read_pose_graph(str(tmp_path))
    cfg = config_from(CFG)
    mgr = tsub.SubmapManager(graph, cfg, search_radius=3.0,
                             warmup_trigger_distance=1.0, res=0.3,
                             device="cpu")
    ctx0 = mgr.initialize([0.0, 0.0, 0.0])
    _ctx_equal(ctx0, build_submap_context(
        *tsub.stitch_submap(graph, [0.0, 0.0, 0.0], 3.0), cfg, res=0.3,
        device="cpu"))
    assert mgr.current([0.5, 0.0, 0.0]) is ctx0       # within the trigger
    assert mgr.current([8.0, 0.0, 0.0]) is ctx0       # prefetch starts
    assert mgr.join(timeout=120.0), "the warm-up thread did not finish"
    ctx1 = mgr.current([8.0, 0.0, 0.0])
    assert ctx1 is not ctx0
    np.testing.assert_array_equal(mgr._center, [8.0, 0.0, 0.0])
    _ctx_equal(ctx1, build_submap_context(
        *tsub.stitch_submap(graph, [8.0, 0.0, 0.0], 3.0), cfg, res=0.3,
        device="cpu"))


# ---------------------------------------------------------------------------
# odom3d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["straight", "pitch_climb"])
def test_odom3d_matches_jax(case):
    """``integrate_log`` of the JAX tests' logs (1 m/s for 2 s straight;
    10 steps pitched -0.2 rad) and of a 200-step log with random speeds,
    rolls, pitches and yaws: path and final pose within 1e-6 m."""
    rng = np.random.default_rng(0)
    if case == "straight":
        q = np.tile(np.float32([[0, 0, 0, 1]]), (20, 1))
        v = np.full((20,), 1.0, np.float32)
    else:
        q = np.tile(np.asarray(j_quat_from_rpy(
            jnp.asarray(0.0), jnp.asarray(-0.2), jnp.asarray(0.0))), (10, 1))
        v = np.full((10,), 1.0, np.float32)
    logs = [(v, q, np.full(v.shape, 0.1, np.float32))]
    r, p, y = (rng.uniform(-a, a, 200).astype(np.float32)
               for a in (0.3, 0.4, 3.1))
    logs.append((rng.uniform(-1, 2, 200).astype(np.float32),
                 np.asarray(j_quat_from_rpy(r, p, y)),
                 rng.uniform(0.05, 0.15, 200).astype(np.float32)))
    for v, q, dt in logs:
        jst, jpath = jax.jit(jodom.integrate_log)(jodom.init_odom3d(), v, q,
                                                  dt)
        tst, tpath = todom.integrate_log(todom.init_odom3d("cpu"), t(v),
                                         t(q), t(dt))
        np.testing.assert_allclose(tpath.numpy(), np.asarray(jpath),
                                   atol=1e-6, rtol=0)
        np.testing.assert_allclose(tst.pos.numpy(), np.asarray(jst.pos),
                                   atol=1e-6, rtol=0)
        np.testing.assert_array_equal(tst.quat.numpy(), np.asarray(jst.quat))
    first = todom.integrate_log(todom.init_odom3d("cpu"),
                                *(t(a) for a in logs[0]))[0].pos.numpy()
    if case == "straight":
        np.testing.assert_allclose(first, [2.0, 0.0, 0.0], atol=1e-5)
    else:
        assert first[2] > 0.15       # sin(0.2) ≈ 0.199 a metre
    st = todom.odom3d_step(todom.init_odom3d("cpu"), t(np.float32(1.0)),
                           t(logs[0][1][0]), t(np.float32(0.1)))
    jst = jodom.odom3d_step(jodom.init_odom3d(), 1.0, logs[0][1][0], 0.1)
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(jst.pos),
                               atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# feature weights (`cbLeGoFeatureCloud`, mcl_3dl.cpp:300-443)
# ---------------------------------------------------------------------------

def _pad_pts(pts, n=256):
    out = np.zeros((n, 3), np.float32)
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    out[:len(pts)] = pts
    mask = np.zeros((n,), bool)
    mask[:len(pts)] = True
    return out, mask


def _walls_and_plate():
    """The JAX test's y-dominant scene: two walls along x and a tilted
    plate."""
    xs = np.arange(0, 4, 0.1)
    wall1 = np.stack([xs, np.zeros_like(xs), np.full_like(xs, 0.5)], 1)
    wall2 = np.stack([xs, np.full_like(xs, 3.0), np.full_like(xs, 0.5)], 1)
    n = np.array([1.0, 0.6, 0.0]); n /= np.linalg.norm(n)
    u = np.array([0.6, -1.0, 0.0]); u /= np.linalg.norm(u)
    v = np.array([0.0, 0.0, 1.0])
    aa, bb = np.meshgrid(np.arange(0, 0.5, 0.1), np.arange(0, 0.5, 0.1))
    plate = (np.array([5.0, 0.0, 0.0])[None, :]
             + aa.ravel()[:, None] * u[None, :]
             + bb.ravel()[:, None] * v[None, :])
    return np.concatenate([wall1, wall2, plate])


def _blobs():
    rng = np.random.default_rng(3)
    return np.concatenate([rng.normal([0, 0, 0.5], 0.2, (30, 3)),
                           rng.normal([5, 5, 0.5], 0.2, (10, 3))])


SCENES = {
    "walls_and_plate": _walls_and_plate,
    "blobs": _blobs,
    "uniform": lambda: np.random.default_rng(0).uniform(-3, 3, (40, 3)),
    "dense": lambda: np.random.default_rng(5).uniform(-2, 2, (200, 3)),
}


def test_voxel_downsample_flat_matches_jax():
    """The keep mask, exactly: the JAX test's four points (three cells)
    and random clouds, eager and jitted."""
    p, m = _pad_pts([[0.1, 0.1, 0.0], [0.2, 0.3, 0.05], [1.5, 0.1, 0.0],
                     [0.1, 0.1, 0.25]])
    _, keep = tfw.voxel_downsample_flat(t(p), t(m))
    assert int(keep.sum()) == 3
    rng = np.random.default_rng(2)
    for n in (4, 60, 180, 256):
        p, m = _pad_pts(rng.uniform(-3, 3, (n, 3)) if n != 4 else
                        [[0.1, 0.1, 0.0], [0.2, 0.3, 0.05], [1.5, 0.1, 0.0],
                         [0.1, 0.1, 0.25]])
        if n == 180:
            p[:, 2] = np.round(p[:, 2], 1)       # z on the leaf's edges
        _, want = jax.jit(jfw.voxel_downsample_flat)(p, m)
        _, eager = jfw.voxel_downsample_flat(jnp.asarray(p), jnp.asarray(m))
        _, got = tfw.voxel_downsample_flat(t(p), t(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), np.asarray(eager))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_knn_normals_and_clusters_match_jax(scene):
    """kNN indices and cluster labels exactly; normals within 1e-5."""
    p, m = _pad_pts(SCENES[scene]())
    want_idx = jax.jit(lambda p, m: jax.lax.top_k(-jnp.where(
        m[None, :] & m[:, None], jnp.sum((p[:, None] - p[None]) ** 2, -1),
        1e12), 5)[1])(p, m)
    np.testing.assert_array_equal(tfw._knn(t(p), t(m), 5).numpy(),
                                  np.asarray(want_idx))
    jn = np.asarray(jax.jit(jfw.knn_normals)(p, m))
    tn = tfw.knn_normals(t(p), t(m)).numpy()
    np.testing.assert_allclose(tn[m], jn[m], atol=1e-5, rtol=0)
    jl = jax.jit(jfw.label_clusters, static_argnums=2)(
        p, m, CFG.euc_cluster_distance)
    tl = tfw.label_clusters(t(p), t(m), CFG.euc_cluster_distance)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_sharp_feature_weights_match_jax(scene):
    """Keep mask exactly, weights within 1e-6; the scene takes the
    dominant branch or the cluster branch as in the JAX package."""
    p, m = _pad_pts(SCENES[scene]())
    jw, jk = jax.jit(jfw.sharp_feature_weights, static_argnums=0)(CFG, p, m)
    tw, tk = tfw.sharp_feature_weights(config_from(CFG), t(p), t(m))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=0)
    if scene == "walls_and_plate":       # the JAX test's own claims
        n_wall = 80
        assert (tw.numpy()[n_wall:105][tk.numpy()[n_wall:105]] < 0.2).all()


def test_preprocess_features_matches_jax():
    """The whole preprocessing on the JAX test's random scan (jitted, as
    it runs in the JAX package)."""
    rng = np.random.default_rng(0)
    flat, fm = _pad_pts(rng.uniform(-3, 3, (60, 3)))
    sharp, sm = _pad_pts(rng.uniform(-3, 3, (40, 3)))
    want = jax.jit(jfw.preprocess_features, static_argnums=0)(
        CFG, flat, fm, sharp, sm)
    got = tfw.preprocess_features(config_from(CFG), t(flat), t(fm), t(sharp),
                                  t(sm))
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 4:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool((got[4] > 0).all()) and int(got[1].sum()) <= int(fm.sum())


# ---------------------------------------------------------------------------
# global localization (mcl_3dl.cpp:661-679 + pf.h:387-430)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [2, 3, 48])
def test_resize_particles_matches_jax(m):
    """Systematic resize of the same particles: the JAX test's four (one
    dominant) to 2, and 64 random-weighted ones to 3 and 48, exactly."""
    cases = []
    pos = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]], np.float32)
    cases.append((pos, np.zeros(4, np.float32),
                  np.float32([0.05, 0.8, 0.05, 0.1])))
    rng = np.random.default_rng(m)
    w = rng.exponential(1.0, 64).astype(np.float32)
    cases.append((rng.uniform(-3, 3, (64, 3)).astype(np.float32),
                  rng.uniform(-3, 3, 64).astype(np.float32), w / w.sum()))
    for pos, yaws, prob in cases:
        if m > len(prob) and len(prob) == 4:
            continue
        jp = jpf.seed_particles_at(jnp.asarray(pos), jnp.asarray(yaws))
        jp = jp._replace(prob=jnp.asarray(prob))
        want = jax.jit(jpf.resize_particles, static_argnums=1)(jp, m)
        tp = tpf.PFState(*(t(np.asarray(x))[None] for x in jp))
        got = tpf.resize_particles(tp, m)
        for f in tpf.PFState._fields:
            np.testing.assert_array_equal(getattr(got, f)[0].numpy(),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        if len(prob) == 4:
            assert (got.pos[0, :, 0] == 1.0).sum() >= 1


def test_seed_global_state_matches_jax():
    """The seed from JAX's own node and yaw draws: positions, the yaw grid
    (``jnp.linspace``'s) and the state's zeros exactly; quaternions within
    1e-6; the center (the mean of the positions) within 1e-6 m."""
    from dddmr_navigation_tpu.state_estimation.global_localization import (
        seed_global_state as j_seed)
    from tools.make_globalloc_golden import jax_seed_draws
    sc = entry.global_localization_scenario()
    key = jax.random.PRNGKey(3)
    want = j_seed(key, CFG, sc.ground_pts, 2048, yaw_samples=16)
    node_idx, yaw_idx = jax_seed_draws(key, len(sc.ground_pts), 2048, 16)
    got = seed_global_state(config_from(CFG), t(sc.ground_pts),
                            port_seed_draws(dict(node_idx=node_idx,
                                                 yaw_idx=yaw_idx), "cpu"),
                            yaw_samples=16)
    gf = {k: v[0] for k, v in mcl_fields(got).items()}
    wf = mcl_fields(want)
    for k in wf:
        if k in ("mcl_particles_quat",):
            np.testing.assert_allclose(gf[k], wf[k], atol=1e-6, rtol=0)
        elif k.startswith(("mcl_state_prev_pos", "mcl_f_pos")):
            np.testing.assert_allclose(gf[k], wf[k], atol=1e-6, rtol=0)
        else:
            np.testing.assert_array_equal(gf[k], wf[k], err_msg=k)
    grid = np.asarray(jnp.linspace(-jnp.pi, jnp.pi, 16, endpoint=False))
    from dddmr_navigation_tpu_torch.state_estimation.global_localization \
        import yaw_grid
    np.testing.assert_array_equal(yaw_grid(16, "cpu").numpy(), grid)


def test_draw_seed_covers_its_ranges():
    """``draw_seed`` draws as ``jax.random.randint`` does: node indices in
    [0, G) and yaw cells in [0, yaw_samples), each value of both ranges
    drawn (64 draws per node)."""
    g, yaws = 300, 16
    d = draw_seed(torch.Generator().manual_seed(5), 64 * g, g, yaws, "cpu")
    assert d.node_idx.dtype == d.yaw_idx.dtype == torch.int64
    assert torch.equal(torch.unique(d.node_idx), torch.arange(g))
    assert torch.equal(torch.unique(d.yaw_idx), torch.arange(yaws))


def test_global_localization_chain_matches_jax():
    """The JAX test's world at num_start 256, shrink_every 1, JAX's seed
    and update draws fed to the port: the counts run 256 → 192 → 144 →
    108 → 81 → 60 → 45 → 33 → 32, then the countdown of 7 drains; counts,
    ``fix_cnt`` and the tick of the fix exactly, unforced: each tick's
    estimate and particles within the fleet's rtol 2e-6 (atol 1e-6), the
    map→odom LPF states within rtol 2e-6, atol 2e-5."""
    from tools.make_globalloc_golden import jax_global_chain
    sc = entry.global_localization_scenario(num_start=256, shrink_every=1,
                                            ticks=20)
    node_idx, yaw_idx, recs = jax_global_chain(sc)
    gl = entry.make_global_localization(
        sc, seed_draws=port_seed_draws(dict(node_idx=node_idx,
                                            yaw_idx=yaw_idx), "cpu"),
        device="cpu")
    chain = entry.run_global_localization(
        sc, gl, draws_of=lambda k: port_tick_of_one(recs[k - 1], "cpu")[1],
        keep_states=True)
    assert [r["n"] for r in recs][:9] == [256, 192, 144, 108, 81, 60, 45,
                                          33, 32]
    assert chain.n == [int(r["n"]) for r in recs]
    assert chain.fix_cnt == [int(r["fix_cnt"]) for r in recs]
    assert chain.fixed == [bool(r["fixed"]) for r in recs]
    assert chain.fixed[-1] and len(recs) == 8 + 1 + 6 + 1 - 1
    cfg_fix = 1 + int(math.ceil(sc.cfg.lpf_step)) * 3
    assert max(chain.fix_cnt) == cfg_fix
    for k, r in enumerate(recs):
        np.testing.assert_allclose(chain.pose_pos[k][0].numpy(),
                                   r["pose_pos"], rtol=2e-6, atol=1e-6)
        np.testing.assert_allclose(chain.pose_quat[k][0].numpy(),
                                   r["pose_quat"], rtol=2e-6, atol=1e-6)
        if k + 1 < len(recs):           # the state the next tick starts from
            got = mcl_fields(chain.states[k])
            for name, want in recs[k + 1].items():
                if name.startswith("mcl_"):
                    # map→odom is the estimate minus the rotated odometry
                    # (a few metres each), and the LPF's x holds 4× it
                    lpf = name.startswith(("mcl_f_pos", "mcl_f_ang"))
                    np.testing.assert_allclose(
                        got[name][0], want, rtol=2e-6,
                        atol=2e-5 if lpf else 1e-6, err_msg=name)
