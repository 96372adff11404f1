"""The port's perception (dddmr_navigation_tpu_torch.perception and
ops.compaction) against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the jitted JAX
function and its port (batched over a leading robot axis). Tolerances:
exact for indices, voxel keys, grids, labels, cluster sizes and masks;
1e-5 for ranges, centroids and distance fields (sqrt, asin and atan2
round differently in the two frameworks at the ulp level, and the
matmuls sum in another order).
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dddmr_navigation_tpu.geometry import quat_from_yaw as j_quat_from_yaw
from dddmr_navigation_tpu.io.maps import flat_ground_map, box_obstacle
from dddmr_navigation_tpu.ops.compaction import (
    first_k_true_indices as j_first_k)
from dddmr_navigation_tpu.perception import voxel as jvox
from dddmr_navigation_tpu.perception import fov as jfov
from dddmr_navigation_tpu.perception import clustering as jclu
from dddmr_navigation_tpu.perception import marking as jmark
from dddmr_navigation_tpu.perception.static_map import (
    build_map_context as j_build_ctx, distance_to_ground as j_dist_ground,
    near_static as j_near_static)

from dddmr_navigation_tpu_torch.ops.compaction import first_k_true_indices
from dddmr_navigation_tpu_torch.perception import voxel as tvox
from dddmr_navigation_tpu_torch.perception import fov as tfov
from dddmr_navigation_tpu_torch.perception import clustering as tclu
from dddmr_navigation_tpu_torch.perception import marking as tmark
from dddmr_navigation_tpu_torch.perception.static_map import (
    build_map_context, distance_to_ground, near_static)
from dddmr_navigation_tpu_torch.perception.layers import min_dgraph

torch.set_num_threads(1)
# The distance field and the cluster sums are matmuls: full f32, no TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

SPEC = tvox.VoxelSpec(32, 32, 16, 0.05, 0.05)
RI = tfov.RangeImageSpec(rows=16, cols=360, elev_min_deg=-15.0,
                         elev_max_deg=15.0)
PARAMS = tmark.MarkingParams(
    scan_effective_positive_start=0.0, scan_effective_negative_start=0.0,
    segmentation_ignore_ratio=0.5, max_marked_voxels=256,
    max_window_nodes=512)


def jspec(spec):
    return jvox.VoxelSpec(*spec)


def jri(ri):
    return jfov.RangeImageSpec(*ri)


def jparams(p):
    return jmark.MarkingParams(*p)


def t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# compaction and voxel keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(1000, 64), (50, 64), (64, 64)])
def test_first_k_true_indices_matches_jax(n, k):
    rng = np.random.default_rng(n + k)
    mask = rng.uniform(size=(3, n)) < 0.3
    mask[1] = False
    want = np.stack([np.asarray(j_first_k(jnp.asarray(m), k)) for m in mask])
    got = first_k_true_indices(t(mask), k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_world_to_cell_matches_jit_at_negative_coordinates():
    """Truncation toward zero, and the jitted JAX rounding (a multiply by
    the f32 reciprocal of the resolution), at keys near cell boundaries."""
    rng = np.random.default_rng(1)
    base = rng.integers(-200, 200, size=(2, 4000, 3)) * 0.05
    pts = (base + rng.normal(0, 1e-6, size=base.shape)).astype(np.float32)
    pts[0, :10] = [-0.04, -0.06, 0.0]
    want = np.asarray(jax.jit(partial(jvox.world_to_cell, jspec(SPEC)))(pts))
    got = tvox.world_to_cell(SPEC, t(pts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[0, :10, 0] == 0).all() and (got[0, :10, 1] == -1).all()


@pytest.mark.parametrize("shift", [(3, -2, 1), (-5, 4, -3), (40, 0, 0)])
def test_scroll_grid_matches_jax(shift):
    rng = np.random.default_rng(2)
    grid = (rng.uniform(size=(2,) + tuple(SPEC[:3])) < 0.2).astype(np.uint8)
    origin = np.array([[10, -4, 2], [0, 0, 0]], np.int32)
    new = origin + np.array([shift, [-s for s in shift]], np.int32)
    want = np.stack([np.asarray(jvox.scroll_grid(jnp.asarray(grid[i]),
                                                 jnp.asarray(origin[i]),
                                                 jnp.asarray(new[i])))
                     for i in range(2)])
    got = tvox.scroll_grid(t(grid), t(origin), t(new))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# FOV and the range image
# ---------------------------------------------------------------------------

def scan_world(seed, n=3000):
    """Random global points around two sensors (B = 2)."""
    rng = np.random.default_rng(seed)
    sensor = np.array([[0.3, -0.2, 0.5], [-1.0, 2.0, 0.6]], np.float32)
    yaw = np.array([0.4, -2.0], np.float32)
    quat = np.stack([np.asarray(j_quat_from_yaw(jnp.float32(y))) for y in yaw])
    pts = (sensor[:, None] + rng.uniform([-3, -3, -0.5], [3, 3, 1.0],
                                         size=(2, n, 3))).astype(np.float32)
    mask = rng.uniform(size=(2, n)) < 0.9
    return sensor, quat, pts, mask


def test_range_image_matches_jax():
    sensor, quat, pts, mask = scan_world(3)
    j_img = jax.jit(partial(jfov.build_range_image, jri(RI)))
    j_sph = jax.jit(jfov.sensor_frame_spherical)
    for i in range(2):
        want = np.asarray(j_img(sensor[i], quat[i], pts[i], mask[i]))
        got = tfov.build_range_image(RI, t(sensor), t(quat), t(pts), t(mask))
        np.testing.assert_array_equal(got[i].numpy(), want)
        rng, elev, azim = (x.numpy() for x in tfov.sensor_frame_spherical(
            t(sensor), t(quat), t(pts)))
        wr, we, wa = (np.asarray(x) for x in j_sph(sensor[i], quat[i], pts[i]))
        np.testing.assert_allclose(rng[i], wr, atol=1e-5)
        np.testing.assert_allclose(elev[i], we, atol=1e-4)
        np.testing.assert_allclose(azim[i], wa, atol=1e-4)


# ---------------------------------------------------------------------------
# clustering
# ---------------------------------------------------------------------------

def blobs(seed, shape=(2, 24, 20, 12), n=6):
    """Random boxes of occupancy, some touching, per robot."""
    rng = np.random.default_rng(seed)
    occ = np.zeros(shape, bool)
    for b in range(shape[0]):
        for _ in range(n):
            lo = rng.integers(0, np.array(shape[1:]) - 3)
            hi = lo + rng.integers(1, 6, size=3)
            occ[b, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = True
    occ &= rng.uniform(size=shape) < 0.85
    return occ


@pytest.mark.parametrize("pooled", [False, True])
def test_label_components_matches_jax(pooled):
    occ = blobs(4)
    if pooled:
        fn = jax.jit(partial(jclu.label_components_pooled, pool=2,
                             num_iters=24))
        got_l, got_r = tclu.label_components_pooled(t(occ), 2, 24)
        for i in range(2):
            want_l, want_r = fn(jnp.asarray(occ[i]))
            np.testing.assert_array_equal(got_l[i].numpy(), np.asarray(want_l))
            np.testing.assert_array_equal(got_r[i].numpy(), np.asarray(want_r))
    else:
        fn = jax.jit(partial(jclu.label_components, tol_cells=2, num_iters=24))
        got = tclu.label_components(t(occ), 2, 24)
        for i in range(2):
            np.testing.assert_array_equal(got[i].numpy(),
                                          np.asarray(fn(jnp.asarray(occ[i]))))


def test_label_components_stops_at_num_iters_like_jax():
    """A chain longer than the sweep budget: the labels after exactly
    ``num_iters`` sweeps, unconverged, as the JAX loop leaves them."""
    occ = np.zeros((1, 40, 4, 4), bool)
    occ[0, :, 1, 1] = True
    got = tclu.label_components(t(occ), 1, 5)
    want = jax.jit(partial(jclu.label_components, tol_cells=1, num_iters=5))(
        jnp.asarray(occ[0]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert len(np.unique(got[0].numpy()[occ[0]])) > 1


def test_cluster_table_matches_jax():
    occ = blobs(5)
    rng = np.random.default_rng(5)
    pos = rng.uniform(-5, 5, size=occ.shape + (3,)).astype(np.float32)
    labels = tclu.label_components(t(occ), 2, 24)
    cen, sizes, idx = tclu.cluster_table(labels, t(occ), t(pos), 8)
    fn = jax.jit(partial(jclu.cluster_table, max_clusters=8))
    for i in range(2):
        wc, ws, wi = fn(jnp.asarray(labels[i].numpy()), jnp.asarray(occ[i]),
                        jnp.asarray(pos[i]))
        np.testing.assert_array_equal(sizes[i].numpy(), np.asarray(ws))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(wi))
        ok = np.asarray(ws) > 0
        np.testing.assert_allclose(cen[i].numpy()[ok], np.asarray(wc)[ok],
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# static map lookups, and mark/clear over three ticks of a moving robot
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flat_map():
    ground = flat_ground_map(4, 4, 0.25)
    walls = box_obstacle([1.2, 0.8, 0.0], size=(0.3, 0.3, 0.6))
    return ground, walls, j_build_ctx(ground, walls), build_map_context(
        ground, walls, device="cpu")


def test_static_lookups_match_jax(flat_map):
    _, _, jctx, ctx = flat_map
    rng = np.random.default_rng(6)
    pts = rng.uniform([-2.5, -2.5, -0.2], [2.5, 2.5, 0.8],
                      size=(2, 200, 3)).astype(np.float32)
    pts[0, :20] = box_obstacle([1.2, 0.8, 0.0], size=(0.3, 0.3, 0.6))[:20]
    np.testing.assert_allclose(distance_to_ground(ctx, t(pts)).numpy(),
                               np.asarray(j_dist_ground(jctx, pts)), atol=1e-6)
    got = near_static(ctx, t(pts), 0.1).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.jit(partial(j_near_static, radius=0.1))(jctx, pts)))
    assert got.any() and not got.all()


def moving_scans(ticks=3):
    """A box in front of two robots that drive and turn; global-frame
    scan points of the box and the floor, robot and sensor poses."""
    box = box_obstacle([0.5, 0.2, 0.1], size=(0.2, 0.4, 0.25),
                       resolution=0.04)
    floor = np.stack(np.meshgrid(np.arange(-1.5, 1.5, 0.1),
                                 np.arange(-1.5, 1.5, 0.1), [-0.02],
                                 indexing="ij"), -1).reshape(-1, 3)
    cloud = np.concatenate([box, floor]).astype(np.float32)
    n = 1024
    out = []
    for k in range(ticks):
        pos = np.array([[0.1 * k, 0.0, 0.0], [-0.2, 0.05 * k, 0.0]],
                       np.float32)
        yaw = np.array([0.1 * k, -0.2 * k], np.float32)
        quat = np.stack([np.asarray(j_quat_from_yaw(jnp.float32(y)))
                         for y in yaw])
        pts = np.zeros((2, n, 3), np.float32)
        mask = np.zeros((2, n), bool)
        for b in range(2):
            # drop a different subset each tick, so cells get cleared
            keep = np.random.default_rng(10 * k + b).uniform(
                size=len(cloud)) < (0.9 if k < 2 else 0.4)
            sel = cloud[keep][:n]
            pts[b, :len(sel)] = sel
            mask[b, :len(sel)] = True
        sensor = pos + np.array([0.0, 0.0, 0.25], np.float32)
        out.append((pos, quat, sensor, pts, mask))
    return out


def test_perception_update_three_ticks_match_jax(flat_map):
    ground, _, jctx, ctx = flat_map
    g = len(ground)
    j_update = jax.jit(jmark.perception_update, static_argnums=(0, 1, 2))
    scans = moving_scans()
    pos0 = scans[0][0]
    state = tmark.init_marking_state(SPEC, PARAMS, g, t(pos0))
    jstates = [jmark.init_marking_state(jspec(SPEC), jparams(PARAMS), g,
                                        jnp.asarray(pos0[b])) for b in range(2)]
    marked = []
    for pos, quat, sensor, pts, mask in scans:
        state = tmark.perception_update(
            SPEC, RI, PARAMS, state, ctx, t(pts), t(mask), t(pos), t(quat),
            t(sensor), t(quat))
        for b in range(2):
            jstates[b] = j_update(
                jspec(SPEC), jri(RI), jparams(PARAMS), jstates[b], jctx,
                pts[b], mask[b], pos[b], quat[b], sensor[b], quat[b])
            js = jstates[b]
            np.testing.assert_array_equal(state.grid[b].numpy(),
                                          np.asarray(js.grid))
            np.testing.assert_array_equal(state.origin[b].numpy(),
                                          np.asarray(js.origin))
            assert int(state.clear_offset[b]) == int(js.clear_offset)
            np.testing.assert_allclose(state.dgraph[b].numpy(),
                                       np.asarray(js.dgraph), atol=1e-5)
        marked.append(int(state.grid.sum()))
    # the scans mark cells, and the sparse third scan clears some
    assert marked[0] > 0 and marked[2] != marked[1], marked
    composed = min_dgraph(torch.full((g,), 5.0), state.dgraph)
    assert (composed <= 5.0).all() and (composed < 5.0).any()
