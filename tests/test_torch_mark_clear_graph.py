"""Mark/clear as one CUDA graph per tick (``perception/marking.py``,
``ops/cuda_graph.py``), and the fixed-count label sweeps that let a graph
capture the clustering.

On the CPU: ``label_components`` runs exactly ``num_iters`` sweeps, where
``ops.fixpoint.iterate_to_fixpoint`` stops each robot at its fixpoint; the
labels are equal element for element. On the card (marked ``cuda``,
skipped without one): the graph against the eager step, tick by tick.
This file imports no JAX, so the card can run it whole.
"""
import numpy as np
import pytest
import torch

from dddmr_navigation_tpu_torch import entry
from dddmr_navigation_tpu_torch.ops.fixpoint import iterate_to_fixpoint
from dddmr_navigation_tpu_torch.perception import clustering as tclu
from dddmr_navigation_tpu_torch.perception.static_map import (
    build_map_context)

torch.set_num_threads(1)


def fixpoint_labels(occ, tol, num_iters):
    """The labels as the JAX loop leaves them: each robot stops at its
    fixpoint. Returns (labels, iterations each robot ran)."""
    x0, sweep = tclu._label_sweep(occ, tol)
    labels, iters = iterate_to_fixpoint(sweep, x0, num_iters, block=8)
    return torch.where(occ.bool(), labels, -1), iters


def pooled_reference(occ, p, num_iters):
    """``label_components_pooled`` with the fixpoint loop and the
    upsampling by ``repeat_interleave``."""
    b, x, y, z = occ.shape
    xp, yp, zp = -(-x // p), -(-y // p), -(-z // p)
    padded = torch.nn.functional.pad(
        occ, (0, zp * p - z, 0, yp * p - y, 0, xp * p - x))
    occ_p = padded.view(b, xp, p, yp, p, zp, p).any(6).any(4).any(2)
    lab_p, _ = fixpoint_labels(occ_p, 1, num_iters)
    lin = torch.arange(xp * yp * zp, dtype=torch.int32).view(xp, yp, zp)
    root = (occ_p & (lab_p == lin)).view(b, -1)
    up = lab_p.repeat_interleave(p, 1).repeat_interleave(p, 2) \
        .repeat_interleave(p, 3)[:, :x, :y, :z]
    return torch.where(occ, up, -1), root


def chains(shape, lengths):
    """Robot b holds a straight chain of ``lengths[b]`` cells (empty at 0)
    and a 2×2×2 blob: a chain converges after about its length in
    sweeps."""
    occ = np.zeros(shape, bool)
    for b, n in enumerate(lengths):
        occ[b, :n, 1, 1] = True
        occ[b, -2:, -2:, -2:] = n > 0
    return torch.as_tensor(occ)


def blobs(shape, seed):
    rng = np.random.default_rng(seed)
    occ = np.zeros(shape, bool)
    for b in range(shape[0]):
        for _ in range(6):
            lo = rng.integers(0, np.array(shape[1:]) - 3)
            hi = lo + rng.integers(1, 6, size=3)
            occ[b, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = True
    occ &= rng.uniform(size=shape) < 0.85
    return torch.as_tensor(occ)


@pytest.mark.parametrize("case", ["staggered", "unconverged", "empty"])
def test_fixed_sweeps_equal_the_fixpoint_loop(case):
    if case == "staggered":
        # robots converging at different sweeps, all within the budget
        occ, tol, n = chains((4, 20, 4, 4), [3, 9, 18, 0]), 1, 24
    elif case == "unconverged":
        # chains longer than the budget: every robot runs out of sweeps
        occ, tol, n = chains((2, 40, 4, 4), [40, 33]), 1, 5
    else:
        occ, tol, n = torch.zeros((2, 8, 8, 4), dtype=torch.bool), 2, 24
    want, iters = fixpoint_labels(occ, tol, n)
    got = tclu.label_components(occ, tol, n)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
    if case == "staggered":
        assert len(set(iters.tolist())) == 4 and int(iters.max()) < n
    elif case == "unconverged":
        assert iters.tolist() == [n, n]
        assert len(torch.unique(got[0][occ[0]])) > 1
    else:
        assert (got == -1).all()


@pytest.mark.parametrize("shape,pool", [((3, 15, 13, 9), 2),
                                        ((2, 16, 16, 8), 2),
                                        ((2, 14, 10, 7), 3)])
def test_fixed_sweeps_equal_the_fixpoint_loop_pooled(shape, pool):
    occ = blobs(shape, sum(shape) + pool)
    want_l, want_r = pooled_reference(occ, pool, 24)
    got_l, got_r = tclu.label_components_pooled(occ, pool, 24)
    assert torch.equal(got_l, want_l)
    assert torch.equal(got_r, want_r)
    assert (got_l >= 0).any()


# ---------------------------------------------------------------------------
# on the card: the graph against the eager step
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("robots,pool", [(1, 1), (4, 2)])
def test_mark_clear_graph_matches_the_eager_step(cuda_device, robots, pool):
    sc = entry.mark_clear_scenario(robots, pool, ticks=12)
    ctx = build_map_context(sc.ground, sc.walls, device=cuda_device)
    got = entry.run_mark_clear_pair(sc, ctx, cuda_device)
    assert got["mismatch"] == []
    assert got["aliased"] == []
    assert (got["captures"], got["replays"]) == (1, 11)
    c = got["counters"]
    assert (c["mark_clear.graph_capture"], c["mark_clear.graph_replay"]) \
        == (1, 11)
    seen, kept = got["eager_counts"]
    assert (c["marked_cells"], c["marked_kept"]) == (seen, kept)
    assert seen > 0
    # a new map is a new graph, though its tables are equal
    ctx2 = build_map_context(sc.ground, sc.walls, device=cuda_device)
    again = entry.run_mark_clear_pair(sc, ctx2, cuda_device)
    assert (again["captures"], again["replays"]) == (1, 11)
    assert again["mismatch"] == [] and again["aliased"] == []
