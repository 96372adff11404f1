"""The port's global planner (dddmr_navigation_tpu_torch.planning.global_)
against the JAX package, on the CPU.

Each stage is fed JAX's own inputs (teacher-forced): the relaxation JAX's
entry costs and tables, the extraction JAX's relaxed field. Relaxation and
extraction are adds, mins and argmins in the JAX version's order, so the
tolerance there is none: fields, iteration counts, node ids, lengths and
flags are equal exactly. Entry costs take an ``exp``, which the port
rounds as XLA does (``rounding.exp_fma``): exact too. Maps: a reduced
``multi_level_map(resolution=0.5)`` with ``turning_weight`` 0.1 (16
direction bins), and a sparse random ground whose kNN fallback makes long
edges for the line-of-sight gate.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddmr_navigation_tpu.config import GlobalPlannerConfig
from dddmr_navigation_tpu.io.maps import multi_level_map
from dddmr_navigation_tpu.planning.global_ import wavefront as jw
from dddmr_navigation_tpu.planning.global_ import planner as jp
from dddmr_navigation_tpu.planning.global_.graph import build_ground_graph
from dddmr_navigation_tpu.planning.global_.los import (
    long_edge_los_mask as j_los, lethal_cloud_from_dgraph as j_lethal)

from dddmr_navigation_tpu_torch.planning.global_ import wavefront as tw
from dddmr_navigation_tpu_torch.planning.global_ import planner as tp
from dddmr_navigation_tpu_torch.interop import config_from
from dddmr_navigation_tpu_torch.planning.global_.los import (
    long_edge_los_mask, lethal_cloud_from_dgraph)

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

TW = 0.1     # turning_weight
BINS = 16


def t(x):
    return torch.as_tensor(np.asarray(x))


class Graph:
    def __init__(self, ground, radius=0.5):
        g = build_ground_graph(ground, radius=radius, k_max=16)
        self.ground = np.asarray(ground, np.float32)
        self.idx, self.dist, self.valid = g.nbr_idx, g.nbr_dist, g.nbr_valid
        self.avg = g.avg_intensity
        self.n = len(ground)
        self.az = np.asarray(jw.edge_azimuth(jnp.asarray(self.ground),
                                             jnp.asarray(self.idx)))
        self.bins = np.asarray(jnp.mod(jnp.floor(
            (jnp.asarray(self.az) + jnp.pi) / (2.0 * jnp.pi) * BINS
        ).astype(jnp.int32), BINS))
        self.tpen = np.asarray(jw.turning_penalty_table(
            jnp.asarray(self.idx), jnp.asarray(self.ground), TW))

    def dgraph(self, seed):
        """A distance field with some lethal nodes."""
        rng = np.random.default_rng(seed)
        d = rng.uniform(0.6, 4.0, size=self.n).astype(np.float32)
        d[rng.uniform(size=self.n) < 0.05] = 0.3
        return d


@pytest.fixture(scope="module")
def ml():
    return Graph(multi_level_map(resolution=0.5)[0])


@pytest.fixture(scope="module")
def sparse():
    rng = np.random.default_rng(7)
    ground = np.concatenate([
        rng.uniform([0, 0, 0], [8, 8, 0], size=(150, 3)),
        [[0.2, 0.2, 0.0], [7.8, 7.8, 0.0]]]).astype(np.float32)
    return Graph(ground)


@pytest.fixture(scope="module")
def j_relax_turning():
    return jax.jit(jw.wavefront_distances_turning,
                   static_argnames=("turning_weight", "n_dir_bins",
                                    "max_iters"))


@pytest.fixture(scope="module")
def j_relax_plain():
    return jax.jit(jw.wavefront_distances, static_argnames=("max_iters",))


def j_enter(gr, dg):
    return np.asarray(jax.jit(partial(
        jw.node_costs, inscribed_radius=0.5, inflation_descending_rate=2.0))(
            jnp.asarray(dg), jnp.zeros(gr.n)))


def test_node_costs_match_jax(ml):
    dg = np.stack([ml.dgraph(0), ml.dgraph(1)])
    weight = np.random.default_rng(2).uniform(1, 1.5, ml.n).astype(np.float32)
    got = tw.node_costs(t(dg), t(weight), inscribed_radius=0.5,
                        inflation_descending_rate=2.0).numpy()
    for b in range(2):
        want = np.asarray(jax.jit(partial(
            jw.node_costs, inscribed_radius=0.5,
            inflation_descending_rate=2.0))(dg[b], weight))
        assert np.isinf(want).any()
        np.testing.assert_array_equal(got[b], want)


def test_edge_tables_match_jax(ml):
    np.testing.assert_array_equal(
        tw.edge_bins(t(ml.az), BINS).numpy(), ml.bins)
    az = tw.edge_azimuth(t(ml.ground), t(ml.idx)).numpy()
    np.testing.assert_allclose(az, ml.az, atol=1e-6)
    tpen = tw.turning_penalty_table(t(ml.idx), t(ml.ground), TW).numpy()
    np.testing.assert_allclose(tpen, ml.tpen, atol=1e-6)


GOALS = (5, 300)     # one robot per goal


@pytest.mark.parametrize("warm", [False, True])
def test_turning_relaxation_teacher_forced_exact(ml, j_relax_turning, warm):
    enter = np.stack([j_enter(ml, ml.dgraph(3)), j_enter(ml, ml.dgraph(4))])
    dist0 = None
    if warm:
        # the cold fields, then costs that rose in one place and dropped
        # in another
        dist0 = np.stack([np.asarray(j_relax_turning(
            ml.idx, ml.dist, ml.valid, enter[b], ml.avg, GOALS[b], ml.ground,
            turning_weight=TW, n_dir_bins=BINS, max_iters=512, az=ml.az,
            bin_of_edge=ml.bins)[0]) for b in range(2)])
        enter = enter.copy()
        enter[:, 100:140] += 2.0
        enter[:, 400:420] *= 0.5
    got, _, iters = tw.wavefront_distances_turning(
        t(ml.idx), t(ml.dist), t(ml.valid)[None], t(enter), t(ml.avg),
        t(GOALS), t(ml.ground), TW, n_dir_bins=BINS, max_iters=512,
        dist0=None if dist0 is None else t(dist0), az=t(ml.az),
        bin_of_edge=t(ml.bins))
    for b in range(2):
        want, _, w_iters = j_relax_turning(
            ml.idx, ml.dist, ml.valid, enter[b], ml.avg, GOALS[b], ml.ground,
            turning_weight=TW, n_dir_bins=BINS, max_iters=512,
            dist0=None if dist0 is None else dist0[b], az=ml.az,
            bin_of_edge=ml.bins)
        assert int(iters[b]) == int(w_iters) > 1
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_turning_relaxation_stops_at_max_iters_like_jax(ml, j_relax_turning):
    enter = j_enter(ml, ml.dgraph(5))
    got, _, iters = tw.wavefront_distances_turning(
        t(ml.idx), t(ml.dist), t(ml.valid)[None], t(enter)[None], t(ml.avg),
        t([7]), t(ml.ground), TW, n_dir_bins=BINS, max_iters=10,
        az=t(ml.az), bin_of_edge=t(ml.bins))
    want, _, w_iters = j_relax_turning(
        ml.idx, ml.dist, ml.valid, enter, ml.avg, 7, ml.ground,
        turning_weight=TW, n_dir_bins=BINS, max_iters=10, az=ml.az,
        bin_of_edge=ml.bins)
    assert int(iters[0]) == int(w_iters) == 10
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("warm", [False, True])
def test_plain_relaxation_teacher_forced_exact(ml, j_relax_plain, warm):
    enter = np.stack([j_enter(ml, ml.dgraph(6)), j_enter(ml, ml.dgraph(7))])
    dist0 = None
    if warm:
        dist0 = np.stack([np.asarray(j_relax_plain(
            ml.idx, ml.dist, ml.valid, enter[b], ml.avg, GOALS[b]).dist)
            for b in range(2)])
        enter = enter.copy()
        enter[:, 50:90] += 1.5
    got = tw.wavefront_distances(
        t(ml.idx), t(ml.dist), t(ml.valid)[None], t(enter), t(ml.avg),
        t(GOALS), max_iters=512, dist0=None if dist0 is None else t(dist0))
    for b in range(2):
        want = j_relax_plain(ml.idx, ml.dist, ml.valid, enter[b], ml.avg,
                             GOALS[b], max_iters=512,
                             dist0=None if dist0 is None else dist0[b])
        assert int(got.iters[b]) == int(want.iters)
        np.testing.assert_array_equal(got.dist[b].numpy(),
                                      np.asarray(want.dist))


@pytest.mark.parametrize("turning", [True, False])
def test_extraction_teacher_forced_exact(ml, j_relax_turning, j_relax_plain,
                                         turning):
    enter = np.stack([j_enter(ml, ml.dgraph(8)), j_enter(ml, ml.dgraph(9))])
    starts = (250, 40)
    if turning:
        fields = np.stack([np.asarray(j_relax_turning(
            ml.idx, ml.dist, ml.valid, enter[b], ml.avg, GOALS[b], ml.ground,
            turning_weight=TW, n_dir_bins=BINS, max_iters=512, az=ml.az,
            bin_of_edge=ml.bins)[0]) for b in range(2)])
        fn = jax.jit(partial(jw.extract_path_turning, turning_weight=TW,
                             max_len=128))
        got = tw.extract_path_turning(
            t(ml.idx), t(ml.dist), t(ml.valid)[None], t(enter), t(fields),
            t(ml.bins), t(starts), t(GOALS), t(ml.ground), TW, max_len=128,
            turn_pen=t(ml.tpen))
        want = [fn(ml.idx, ml.dist, ml.valid, enter[b], fields[b], ml.bins,
                   starts[b], GOALS[b], ml.ground, turn_pen=ml.tpen)
                for b in range(2)]
    else:
        fields = np.stack([np.asarray(j_relax_plain(
            ml.idx, ml.dist, ml.valid, enter[b], ml.avg, GOALS[b]).dist)
            for b in range(2)])
        fn = jax.jit(partial(jw.extract_path, max_len=128))
        got = tw.extract_path(t(ml.idx), t(ml.dist), t(ml.valid)[None],
                              t(enter), t(fields), t(starts), t(GOALS),
                              max_len=128)
        want = [fn(ml.idx, ml.dist, ml.valid, enter[b], fields[b], starts[b],
                   GOALS[b]) for b in range(2)]
    for b in range(2):
        for g_, w_ in zip(got, want[b]):
            np.testing.assert_array_equal(g_[b].numpy(), np.asarray(w_))
        assert bool(got[3][b]) and int(got[2][b]) > 5


def test_los_mask_matches_jax(sparse):
    n_long = int((sparse.valid & (sparse.dist >= 1.0)).sum())
    assert n_long > 20
    rng = np.random.default_rng(11)
    dg = np.stack([sparse.dgraph(12), sparse.dgraph(13)])
    dg[:, rng.choice(sparse.n, 40, replace=False)] = 0.2
    valid = np.ones(sparse.n, bool)
    pts, ok = lethal_cloud_from_dgraph(t(sparse.ground), t(valid), t(dg),
                                       inscribed_radius=0.5, max_lethal=64)
    mask = long_edge_los_mask(t(sparse.idx), t(sparse.dist), t(sparse.valid),
                              t(sparse.ground), pts, ok, inscribed_radius=0.5,
                              max_long_edges=256, samples=16)
    blocked = 0
    for b in range(2):
        wp, wo = j_lethal(jnp.asarray(sparse.ground), jnp.asarray(valid),
                          jnp.asarray(dg[b]), inscribed_radius=0.5,
                          max_lethal=64)
        np.testing.assert_array_equal(pts[b].numpy(), np.asarray(wp))
        np.testing.assert_array_equal(ok[b].numpy(), np.asarray(wo))
        want = np.asarray(jax.jit(partial(
            j_los, inscribed_radius=0.5, max_long_edges=256, samples=16))(
                sparse.idx, sparse.dist, sparse.valid, sparse.ground, wp, wo))
        np.testing.assert_array_equal(mask[b].numpy(), want)
        blocked += int((~want).sum())
    assert blocked > 0


def test_plan_prepare_and_finish_match_jax(sparse):
    """plan_prepare with the LOS gate, then plan_finish from JAX's prep and
    relaxed field (the default config: turning over 16 bins)."""
    cfg = GlobalPlannerConfig(max_long_edges=256, los_samples=16,
                              max_relax_iters=200)
    tcfg = config_from(cfg)
    dg = np.stack([sparse.dgraph(14), sparse.dgraph(15)])
    node_w = np.ones(sparse.n, np.float32)
    start = np.array([[0.3, 0.2, 0.0], [7.7, 7.9, 0.0]], np.float32)
    goal = np.array([[7.8, 7.7, 0.0], [0.1, 0.2, 0.0]], np.float32)
    valid = np.ones(sparse.n, bool)
    pts, ok = lethal_cloud_from_dgraph(t(sparse.ground), t(valid), t(dg),
                                       inscribed_radius=0.5, max_lethal=64)
    warm = np.full((2, sparse.n, BINS), np.inf, np.float32)
    prep = tp.plan_prepare(
        tcfg, t(sparse.idx), t(sparse.dist), t(sparse.valid), t(sparse.ground),
        t(valid), t(dg), t(node_w), t(start), t(goal), inscribed_radius=0.5,
        inflation_descending_rate=2.0, lethal_pts=pts, lethal_valid=ok,
        warm_dist=t(warm), warm_goal_idx=t([-1, -1]))
    j_prep = jax.jit(partial(jp.plan_prepare, cfg, inscribed_radius=0.5,
                             inflation_descending_rate=2.0))
    j_relax = jax.jit(partial(jw.wavefront_distances_turning,
                              turning_weight=TW, n_dir_bins=BINS,
                              max_iters=cfg.max_relax_iters))
    j_finish = jax.jit(partial(jp.plan_finish, cfg))
    for b in range(2):
        wp = j_prep(sparse.idx, sparse.dist, sparse.valid, sparse.ground,
                    valid, dg[b], node_w, start[b], goal[b],
                    lethal_pts=pts[b].numpy(), lethal_valid=ok[b].numpy(),
                    warm_dist=warm[b], warm_goal_idx=-1)
        for f in ("start_idx", "goal_idx", "sg_ok", "graph_valid"):
            np.testing.assert_array_equal(getattr(prep, f)[b].numpy(),
                                          np.asarray(getattr(wp, f)), f)
        np.testing.assert_array_equal(prep.enter[b].numpy(),
                                      np.asarray(wp.enter))
        # plan_finish from JAX's prep and field: exact
        dist, _, iters = j_relax(sparse.idx, sparse.dist, wp.graph_valid,
                                 wp.enter, sparse.avg, wp.goal_idx,
                                 sparse.ground, az=sparse.az,
                                 bin_of_edge=sparse.bins)
        want = j_finish(sparse.idx, sparse.dist, sparse.ground, wp, dist,
                        iters, turn_pen=sparse.tpen, wf_bins=sparse.bins)
        tprep = tp.PlanPrep(*(t(x)[None] for x in wp[:5]), t(wp.warm_dist)[None])
        got = tp.plan_finish(tcfg, t(sparse.idx), t(sparse.dist),
                             t(sparse.ground), tprep, t(dist)[None],
                             t(iters)[None], turn_pen=t(sparse.tpen),
                             wf_bins=t(sparse.bins))
        for f in tp.GlobalPathResult._fields:
            np.testing.assert_array_equal(getattr(got, f)[0].numpy(),
                                          np.asarray(getattr(want, f)), f)
        assert bool(want.ok)


def test_plan_on_graph_matches_jax(sparse):
    """End to end on the sparse graph (LOS on): the same paths."""
    cfg = GlobalPlannerConfig(max_long_edges=256, los_samples=16,
                              max_relax_iters=200)
    tcfg = config_from(cfg)
    dg = np.stack([sparse.dgraph(16), sparse.dgraph(17)])
    node_w = np.ones(sparse.n, np.float32)
    start = np.array([[0.3, 0.2, 0.0], [7.7, 7.9, 0.0]], np.float32)
    goal = np.array([[7.8, 7.7, 0.0], [0.1, 0.2, 0.0]], np.float32)
    valid = np.ones(sparse.n, bool)
    pts, ok = lethal_cloud_from_dgraph(t(sparse.ground), t(valid), t(dg),
                                       inscribed_radius=0.5, max_lethal=64)
    got = tp.plan_on_graph(
        tcfg, t(sparse.idx), t(sparse.dist), t(sparse.valid), t(sparse.ground),
        t(valid), t(dg), t(node_w), t(sparse.avg), t(start), t(goal),
        inscribed_radius=0.5, inflation_descending_rate=2.0,
        lethal_pts=pts, lethal_valid=ok, turn_pen=t(sparse.tpen),
        wf_az=t(sparse.az), wf_bins=t(sparse.bins))
    fn = jax.jit(partial(jp.plan_on_graph, cfg, inscribed_radius=0.5,
                         inflation_descending_rate=2.0))
    for b in range(2):
        want = fn(sparse.idx, sparse.dist, sparse.valid, sparse.ground,
                  valid, dg[b], node_w, sparse.avg, start[b], goal[b],
                  lethal_pts=pts[b].numpy(), lethal_valid=ok[b].numpy(),
                  turn_pen=sparse.tpen, wf_az=sparse.az, wf_bins=sparse.bins)
        for f in ("node_ids", "node_valid", "length", "ok", "goal_idx",
                  "iters"):
            np.testing.assert_array_equal(getattr(got, f)[b].numpy(),
                                          np.asarray(getattr(want, f)), f)
        np.testing.assert_allclose(got.dist_to_goal[b].numpy(),
                                   np.asarray(want.dist_to_goal), rtol=1e-5)
