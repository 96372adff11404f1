"""The port's kernels (dddmr_navigation_tpu_torch.ops) against the JAX
package's Pallas kernels, run in interpret mode, and their XLA references.

On the CPU the port's wrappers take their plain PyTorch versions; the tests
marked ``cuda`` compare each hand-written kernel with its plain version on
the card and skip where there is none.
"""
from functools import partial

import numpy as np
import jax
import pytest
import torch

from dddmr_navigation_tpu.ops.collision import swept_box_hits as jax_hits
from dddmr_navigation_tpu.ops.distance_field import (
    masked_min_distance as jax_min_dist)
from dddmr_navigation_tpu_torch.ops import (
    swept_box_hits, swept_box_hits_plain,
    masked_min_distance, masked_min_distance_plain)
from dddmr_navigation_tpu_torch.ops import adversarial
from dddmr_navigation_tpu_torch.ops.collision import (
    _tiles, swept_box_cull_plain)
from dddmr_navigation_tpu_torch.ops.distance_field import (
    masked_min_distance_compacted_plain)
from dddmr_navigation_tpu_torch.config import CuboidConfig
from dddmr_navigation_tpu_torch.planning.local.critics import cuboid_box

torch.set_num_threads(1)
# Nothing here is a matmul; TF32 stays off so no comparison could use it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

HALF = cuboid_box(CuboidConfig(), "cpu")[2]     # f32 half extents
MARGIN = 1e-4                                    # min distance to a box face


def box_inputs(seed, b=3, s=25, n=16, m=32):
    """Random boxes and obstacles, with every obstacle at least MARGIN from
    every face plane of every box (hits are then exact compare results)."""
    rng = np.random.default_rng(seed)
    axes = np.linalg.qr(rng.normal(size=(b, s, n, 3, 3)))[0]
    axes = np.ascontiguousarray(np.swapaxes(axes, -1, -2), np.float32)
    centers = rng.uniform(-3.0, 3.0, size=(b, s, n, 3))
    projc = np.einsum("bsnkj,bsnj->bsnk", axes.astype(np.float64),
                      centers).astype(np.float32)
    step_valid = rng.uniform(size=(b, s, n)) < 0.8
    obs = rng.uniform(-3.0, 3.0, size=(b, m, 3)).astype(np.float32)
    half = np.asarray(HALF, np.float64)
    for _ in range(100):
        d = np.abs(np.einsum("bsnkj,bmj->bsnkm", axes.astype(np.float64),
                             obs.astype(np.float64))
                   - projc[..., None].astype(np.float64))
        near = (np.abs(d - half[:, None]) < MARGIN).any(axis=(1, 2, 3))
        if not near.any():
            break
        obs[near] = rng.uniform(-3.0, 3.0, size=(int(near.sum()), 3))
    else:
        raise AssertionError("could not place obstacles off the box faces")
    obs_valid = rng.uniform(size=(b, m)) < 0.9
    return axes, projc, step_valid, obs, obs_valid


@pytest.fixture(scope="module")
def jax_hit_fns():
    half = np.asarray(HALF, np.float32)
    return {be: jax.jit(jax.vmap(partial(jax_hits, half=half, backend=be)))
            for be in ("pallas_interpret", "xla")}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", ["pallas_interpret", "xla"])
def test_swept_box_hits_matches_jax(jax_hit_fns, seed, backend):
    axes, projc, step_valid, obs, obs_valid = box_inputs(seed)
    want = np.asarray(jax_hit_fns[backend](axes, projc, step_valid, obs,
                                           obs_valid))
    got = swept_box_hits(torch.as_tensor(axes), torch.as_tensor(projc),
                         torch.as_tensor(step_valid), torch.as_tensor(obs),
                         torch.as_tensor(obs_valid), HALF)
    assert got.dtype == torch.bool and got.shape == want.shape
    assert 0 < want.sum() < want.size          # both outcomes occur
    np.testing.assert_array_equal(got.numpy(), want)


def dist_inputs(seed, b=3, q=200, m=40):
    rng = np.random.default_rng(seed)
    queries = rng.uniform(-3, 3, size=(b, q, 3)).astype(np.float32)
    points = rng.uniform(-3, 3, size=(b, m, 3)).astype(np.float32)
    # global coordinates of O(10 m), as plans and rollouts have
    queries += np.float32(12.0)
    points += np.float32(12.0)
    q_mask = rng.uniform(size=(b, q)) < 0.8
    p_mask = rng.uniform(size=(b, m)) < 0.7
    p_mask[-1] = False                          # one robot without points
    return queries, q_mask, points, p_mask


@pytest.fixture(scope="module")
def jax_dist_fns():
    return {be: jax.jit(jax.vmap(partial(jax_min_dist, backend=be)))
            for be in ("pallas_interpret", "xla")}


@pytest.mark.parametrize("backend", ["pallas_interpret", "xla"])
def test_masked_min_distance_matches_jax(jax_dist_fns, backend):
    queries, q_mask, points, p_mask = dist_inputs(0)
    want = np.asarray(jax_dist_fns[backend](queries, q_mask, points, p_mask))
    got = masked_min_distance(*map(torch.as_tensor,
                                   (queries, q_mask, points, p_mask)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    # rtol 1e-6: the same f32 operation order on both sides; XLA may
    # round a sum differently by an ulp.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert np.all(got.numpy()[~q_mask] == 1e6)
    np.testing.assert_allclose(got.numpy()[-1], 1e6, rtol=1e-6)


def test_wrappers_reject_other_devices():
    axes, projc, step_valid, obs, obs_valid = map(
        torch.as_tensor, box_inputs(0, b=1, s=2, n=2, m=4))
    with pytest.raises(ValueError, match="no kernel"):
        swept_box_hits(axes.to("meta"), projc, step_valid, obs, obs_valid,
                       HALF)
    q, qm, p, pm = map(torch.as_tensor, dist_inputs(0, b=1, q=4, m=4))
    with pytest.raises(ValueError, match="no kernel"):
        masked_min_distance(q.to("meta"), qm, p, pm)


# ---------------------------------------------------------------------------
# the kernels' culls, mirrored in plain PyTorch: they never drop a true hit
# or a true minimum
# ---------------------------------------------------------------------------

def inside_pairs(axes, projc, step_valid, obs, obs_valid, half):
    """(B, S, N, K) bool: the exact per-pair test of the plain version."""
    proj = torch.einsum("bsnkj,bmj->bsnkm", axes, obs)
    ok = (proj - projc[..., None]).abs() <= torch.tensor(half)[:, None]
    return ok.all(3) & obs_valid[:, None, None, :] & step_valid[..., None]


@pytest.mark.parametrize("case", ["adversarial0", "adversarial1",
                                  "adversarial2", "random0", "random1"])
def test_swept_box_cull_never_drops_a_hit(case):
    seed = int(case[-1])
    make = adversarial.box_inputs if case.startswith("adv") else box_inputs
    args = [torch.as_tensor(a) for a in make(seed)]
    half = adversarial.HALF if case.startswith("adv") else HALF
    keep, rows = swept_box_cull_plain(*args, half)
    inside = _tiles(inside_pairs(*args, half), False)          # (B,W,32,K)
    assert int(inside.sum()) > 0
    assert not bool((inside & ~keep[:, :, None, :]).any())
    assert bool((rows.any(2, keepdim=True) & ~keep).any())      # it culls
    hits = swept_box_hits_plain(*args, half)
    assert 0 < int(hits.sum()) < hits.numel()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("q", [1000, 40000])        # narrow and wide variant
def test_masked_min_distance_compaction_keeps_every_minimum(seed, q):
    args = [torch.as_tensor(a) for a in adversarial.dist_inputs(seed, q=q)]
    staged, got = masked_min_distance_compacted_plain(*args)
    want = masked_min_distance_plain(*args)
    assert torch.equal(got, want)
    m = args[2].shape[1]
    assert staged.tolist() == (args[3].sum(1) + 1).tolist()   # + parking
    assert int(staged.max()) < m                                # it drops
    # robot 2 has no valid point: only the parking point, at distance 0
    # from its five queries there and 1e6 from the rest
    assert bool((want[2, :5] == 0).all())
    assert bool((want[2, 5:][args[1][2, 5:]] > 1e5).all())
    assert bool((want[3] == 1e6).all())


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_swept_box_hits_kernel_matches_plain(cuda_device, seed):
    args = [torch.as_tensor(a, device=cuda_device) for a in box_inputs(seed)]
    before = swept_box_hits.launches
    got = swept_box_hits(*args, HALF)
    torch.cuda.synchronize()
    assert swept_box_hits.launches == before + 1
    want = swept_box_hits_plain(*args, HALF)
    assert 0 < int(want.sum()) < want.numel()  # both outcomes occur
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_masked_min_distance_kernel_matches_plain(cuda_device):
    args = [torch.as_tensor(a, device=cuda_device) for a in dist_inputs(0)]
    before = masked_min_distance.launches
    got = masked_min_distance(*args)
    torch.cuda.synchronize()
    assert masked_min_distance.launches == before + 1
    # the same operation order, no FMA, correctly rounded sqrt: bit equal
    assert torch.equal(got, masked_min_distance_plain(*args))


# The ticks' call shapes: the headline tick's 64 robots of 289 samples and
# the fused config-3 tick's one robot of 64×128 = 8,192, each of 40 steps
# against near-K 128 obstacles; the stick-path call's queries are every
# (sample, step) row (11,560 a robot at the headline, 327,680 fused), the
# toward-plan call's one a sample, both against a 128-pose prune plan.
HEAD_B, HEAD_S = 64, 289
FUSED_S, TICK_N, TICK_K, TICK_P = 8192, 40, 128, 128


def tick_box_inputs(b, s, seed, valid_share):
    """Random boxes and obstacles at a tick's shapes, spread so that some
    samples hit and others do not (no face margin: kernel and plain
    version round the same way, so they agree exactly at any distance)."""
    rng = np.random.default_rng(seed)
    axes = np.linalg.qr(rng.normal(size=(b, s, TICK_N, 3, 3)))[0]
    axes = np.ascontiguousarray(np.swapaxes(axes, -1, -2), np.float32)
    centers = rng.uniform(-3.0, 3.0, size=(b, s, TICK_N, 3))
    projc = np.einsum("bsnkj,bsnj->bsnk", axes.astype(np.float64),
                      centers).astype(np.float32)
    step_valid = rng.uniform(size=(b, s, TICK_N)) < valid_share
    obs = rng.uniform(-6.0, 6.0, size=(b, TICK_K, 3)).astype(np.float32)
    obs_valid = rng.uniform(size=(b, TICK_K)) < 0.9
    return axes, projc, step_valid, obs, obs_valid


@pytest.mark.cuda
@pytest.mark.parametrize("b, s, seed, valid_share", [
    (HEAD_B, HEAD_S, 7, 0.6), (1, FUSED_S, 2, 0.8)],
    ids=["headline", "fused"])
def test_swept_box_hits_kernel_matches_plain_at_tick_shapes(
        cuda_device, b, s, seed, valid_share):
    args = [torch.as_tensor(a, device=cuda_device)
            for a in tick_box_inputs(b, s, seed, valid_share)]
    before = swept_box_hits.launches
    got = swept_box_hits(*args, HALF)
    torch.cuda.synchronize()
    assert swept_box_hits.launches == before + 1
    want = swept_box_hits_plain(*args, HALF)
    assert got.shape == (b, s)
    assert 0 < int(want.sum()) < want.numel()  # both outcomes occur
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b, q, seed, q_share, p_fill", [
    (HEAD_B, HEAD_S * TICK_N, 8, 0.5, None),
    (1, FUSED_S * TICK_N, FUSED_S * TICK_N, 0.8, 100),
    (1, FUSED_S, FUSED_S, 0.8, 100)],
    ids=["headline-stick-path", "fused-stick-path", "fused-toward-plan"])
def test_masked_min_distance_kernel_matches_plain_at_tick_shapes(
        cuda_device, b, q, seed, q_share, p_fill):
    rng = np.random.default_rng(seed)
    queries = (rng.uniform(-3, 3, size=(b, q, 3)) + 12.0).astype(np.float32)
    points = (rng.uniform(-3, 3, size=(b, TICK_P, 3)) + 12.0).astype(
        np.float32)
    q_mask = rng.uniform(size=(b, q)) < q_share
    if p_fill is None:                  # each robot's plan its own length
        p_fill = rng.integers(1, TICK_P, size=(b, 1))
    p_mask = np.arange(TICK_P)[None].repeat(b, 0) < p_fill  # partly filled
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (queries, q_mask, points, p_mask)]
    before = masked_min_distance.launches
    got = masked_min_distance(*args)
    torch.cuda.synchronize()
    assert masked_min_distance.launches == before + 1
    assert torch.equal(got, masked_min_distance_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_swept_box_hits_kernel_matches_plain_on_adversarial_inputs(
        cuda_device, seed):
    args = [torch.as_tensor(a, device=cuda_device)
            for a in adversarial.box_inputs(seed)]
    got = swept_box_hits(*args, adversarial.HALF)
    want = swept_box_hits_plain(*args, adversarial.HALF)
    torch.cuda.synchronize()
    assert 0 < int(want.sum()) < want.numel()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("q", [1000, 40000])        # narrow and wide variant
def test_masked_min_distance_kernel_matches_plain_on_adversarial_inputs(
        cuda_device, seed, q):
    args = [torch.as_tensor(a, device=cuda_device)
            for a in adversarial.dist_inputs(seed, q=q)]
    got = masked_min_distance(*args)
    want = masked_min_distance_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
