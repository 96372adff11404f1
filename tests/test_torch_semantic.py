"""The port's semantic segmentation (``perception/semantic.py`` and the
copies ``semantic_data.py``, ``semantic_scene19.py``) against the JAX
package on the CPU.

Against live JAX, at the real shapes or a small size (net width 8, 32×48,
3 classes, JAX-initialised weights carried through ``interop``):

* the bilinear resize bit for bit at the deployed shapes (bf16 8×10 → 30×40
  and 3×4 → 12×16, the context upsamples of the 19- and 4-class nets; f32
  30×40 → 120×160 and 120×160 → 240×320, the logits upsamples);
* the ``SAME``-padded convolution bit for bit at even and odd sizes;
* each ``ConvBN`` of the small net: equal to flax's but for a residue of one
  bf16 ulp in at most 0.05 % of the elements (the group sums' order: XLA's
  LLVM vectorizes some of them; see ``semantic.group_sums``);
* the whole forward within :data:`LOGITS_TOL`;
* ``segmentation_to_pointcloud`` and ``colorize_classes`` exactly;
* one train step's loss within 1e-5 relative;
* the npz weights file, written by either package, read by the other.

Against the golden file (``tools/make_semantic_golden.py``), no JAX: the
19-class artifact at full width on 8 EVAL frames — the logits of frame 0
within :data:`LOGITS_TOL`, the class mask equal at every pixel whose JAX
top-two gap exceeds 2·:data:`LOGITS_TOL`, at most 0.05 % of the pixels
flipped, mIoU within 0.005 —, the 4-class reroute chain, and the JAX train
test's 12 losses tracked within 2 %.

:data:`LOGITS_TOL` is bf16's: the net's activations are bf16, and where a
sum's order differs (a convolution, a group statistic) an activation
rounds to the next bf16 value now and then; through the last layers that
moves a logit by a few hundredths (0.021-0.035 over the 8 frames on the
CPU, whose logits span ±27).
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as nn

from dddmr_navigation_tpu.perception import semantic as js
from dddmr_navigation_tpu.perception import semantic_data as jd
from dddmr_navigation_tpu.perception import semantic_scene19 as js19

from dddmr_navigation_tpu_torch import entry
from dddmr_navigation_tpu_torch.interop import (
    semantic_params_from, semantic_params_to)
from dddmr_navigation_tpu_torch.perception import semantic as ts
from dddmr_navigation_tpu_torch.perception import semantic_data as td
from dddmr_navigation_tpu_torch.perception import semantic_scene19 as ts19

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dddmr_navigation_tpu_torch", "testdata",
    "semantic_golden.npz")
LOGITS_TOL = 0.05
FLIP_SHARE = 5e-4           # 0.05 % of the pixels
ULP_SHARE = 5e-4


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16()


def _nhwc(t):
    return t.float().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def small():
    """The small net in both packages with the same (JAX-initialised)
    weights, and a batch of 16 frames."""
    jm, jp = js.init_segmenter(jax.random.PRNGKey(0), 32, 48, 3, 8)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    tm, _ = ts.init_segmenter(32, 48, 3, 8, device="cpu")
    tp = semantic_params_from(jp, "cpu")
    tm.load_state_dict(tp)
    rgb = np.random.default_rng(7).uniform(0, 1, (16, 32, 48, 3)).astype(
        np.float32)
    return jm, jp, tm, tp, rgb


# ---------------------------------------------------------------------------
# the resize and the padded convolution, bit for bit
# ---------------------------------------------------------------------------

RESIZES = [((1, 8, 10, 384), (30, 40), "bf16", True),
           ((2, 3, 4, 64), (12, 16), "bf16", True),
           ((1, 30, 40, 19), (120, 160), "f32", True),
           ((2, 120, 160, 19), (240, 320), "f32", False)]


@pytest.mark.parametrize("shape,out,dtype,fused", RESIZES)
def test_resize_matches_jax(shape, out, dtype, fused):
    x = np.random.default_rng(1).normal(0, 3, shape).astype(np.float32)
    if dtype == "bf16":
        xt = _bf16(x)
        xj = jnp.asarray(xt.float().numpy(), jnp.bfloat16)
    else:
        xt = torch.from_numpy(x)
        xj = jnp.asarray(x)
    want = np.asarray(jax.jit(lambda a: jax.image.resize(
        a, (shape[0],) + out + (shape[3],), "bilinear"))(xj).astype(
            jnp.float32))
    got = ts.resize_bilinear(xt.permute(0, 3, 1, 2), *out, fused_h=fused)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(_nhwc(got), want)


def test_resize_weights_match_jax():
    """The weight matrix is ``jax.image.resize``'s: resizing the identity
    reads it out exactly."""
    for n_in, n_out in ((8, 30), (10, 40), (30, 120), (120, 240), (1, 4)):
        eye = jnp.eye(n_in, dtype=jnp.float32)[:, :, None]
        want = np.asarray(jax.image.resize(eye, (n_in, n_out, 1),
                                           "bilinear"))[:, :, 0]
        np.testing.assert_array_equal(ts.resize_weights(n_in, n_out), want)


@pytest.mark.parametrize("size,cin,stride", [
    ((240, 320), 3, 2), ((15, 20), 3, 2), ((15, 20), 8, 2), ((6, 6), 3, 2),
    ((30, 40), 3, 1), ((8, 12), 16, 2)])
def test_same_padded_conv_matches_flax(size, cin, stride):
    """flax's ``SAME``: (0, 1) for a stride-2 3-window on an even size,
    (1, 1) on an odd one; the bf16 convolution's f32 sums equal."""
    x = np.random.default_rng(2).uniform(0, 1, (2,) + size + (cin,)).astype(
        np.float32)
    conv = nn.Conv(16, (3, 3), strides=(stride, stride), use_bias=False,
                   dtype=jnp.bfloat16)
    p = conv.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jax.jit(conv.apply)(p, jnp.asarray(x)).astype(
        jnp.float32))
    tc = ts.Conv(cin, 16, 3, stride)
    tc.weight.data = torch.from_numpy(ts.from_flax_array(
        "w.weight", p["params"]["kernel"]))
    with torch.no_grad():
        got = tc(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(_nhwc(got.bfloat16()), want)
    for n in size:
        lo, hi = ts.same_pads(n, 3, stride)
        assert (lo, hi) == ((0, 1) if stride == 2 and n % 2 == 0
                            else (1, 1))


# ---------------------------------------------------------------------------
# the net at a small size
# ---------------------------------------------------------------------------

CONVBNS = [("ConvBN_0", "rgb"), ("ConvBN_1", "ConvBN_0"),
           ("ConvBN_2", "ConvBN_1"), ("ConvBN_3", "ConvBN_2"),
           ("ConvBN_4", "ConvBN_2"), ("ConvBN_5", "ConvBN_4"),
           ("ConvBN_6", "ConvBN_5"), ("ConvBN_7", "up"),
           ("ConvBN_8", "fused")]


def _port_activations(tm, rgb):
    """The small net's bf16 activations in the port, by layer (and the
    upsampled context ``up`` and the fusion ``fused``)."""
    with torch.no_grad():
        a = {"rgb": torch.from_numpy(rgb).permute(0, 3, 1, 2).bfloat16()}
        a["ConvBN_0"] = tm.ConvBN_0(a["rgb"])
        a["ConvBN_1"] = tm.ConvBN_1(a["ConvBN_0"])
        a["ConvBN_2"] = tm.ConvBN_2(a["ConvBN_1"])
        a["ConvBN_3"] = tm.ConvBN_3(a["ConvBN_2"])
        a["ConvBN_4"] = tm.ConvBN_4(a["ConvBN_2"])
        a["ConvBN_5"] = tm.ConvBN_5(a["ConvBN_4"])
        a["ConvBN_6"] = tm.ConvBN_6(a["ConvBN_5"])
        a["up"] = ts.resize_bilinear(a["ConvBN_6"], *a["ConvBN_3"].shape[-2:])
        a["ConvBN_7"] = tm.ConvBN_7(a["up"])
        a["fused"] = torch.relu(a["ConvBN_3"] + a["ConvBN_7"])
    return a


@pytest.mark.parametrize("name,src", CONVBNS)
def test_convbn_matches_flax(small, name, src):
    """Each ``ConvBN`` of the small net, flax's module jitted alone against
    the port's on the same bf16 input (the port's upstream activation):
    equal but for one bf16 ulp in at most 0.05 % of the elements."""
    jm, jp, tm, tp, rgb = small
    inp = _port_activations(tm, rgb)[src]
    with torch.no_grad():
        got = getattr(tm, name)(inp)
    conv = getattr(tm, name).Conv_0
    mod = js.ConvBN(conv.weight.shape[0], strides=conv.stride,
                    kernel=conv.kernel)
    params = {"params": jp["params"][name]}
    want = np.asarray(jax.jit(mod.apply)(
        params, jnp.asarray(_nhwc(inp), jnp.bfloat16)).astype(jnp.float32))
    g = _nhwc(got)
    diff = g != want
    assert diff.mean() <= ULP_SHARE, (name, int(diff.sum()), diff.size)
    if diff.any():
        ulp = np.abs(want[diff]) * 2.0 ** -7
        assert (np.abs(g[diff] - want[diff]) <= ulp * 1.001).all()


def test_forward_matches_flax_small(small):
    jm, jp, tm, tp, rgb = small
    want = np.asarray(jax.jit(jm.apply)(jp, jnp.asarray(rgb)))
    with torch.no_grad():
        got = tm(torch.from_numpy(rgb)).numpy()
    assert got.shape == want.shape == (16, 16, 24, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGITS_TOL)
    # functional parameters give the module's own result
    with torch.no_grad():
        again = torch.func.functional_call(tm, tp, (torch.from_numpy(rgb),))
    np.testing.assert_array_equal(again.numpy(), got)


def test_infer_classes_small(small):
    jm, jp, tm, tp, rgb = small
    want = np.asarray(js.infer_classes(jm, jp, jnp.asarray(rgb)))
    got = ts.infer_classes(tm, tp, torch.from_numpy(rgb))
    assert got.dtype == torch.int32 and got.shape == (16, 32, 48)
    assert (got.numpy() != want).mean() <= 0.01


def test_init_segmenter_shapes_and_statistics():
    """flax's initializers: LeCun-normal kernels (variance 1/fan_in),
    unit GroupNorm scales, zero biases; the same names and shapes as the
    JAX params."""
    _, jp = js.init_segmenter(jax.random.PRNGKey(0), 32, 48, 19, 16)
    tm, tp = ts.init_segmenter(32, 48, 19, 16, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    flat = semantic_params_to(tp)
    jflat = jax.tree_util.tree_map(lambda a: np.asarray(a).shape, jp)
    assert jax.tree_util.tree_map(np.shape, flat) == jflat
    w = tp["ConvBN_5.Conv_0.weight"]
    fan_in = w.shape[1] * 9
    assert abs(float(w.var()) * fan_in - 1.0) < 0.05
    assert torch.all(tp["ConvBN_5.GroupNorm_0.scale"] == 1)
    assert torch.all(tp["Conv_0.bias"] == 0)


# ---------------------------------------------------------------------------
# weights across the packages
# ---------------------------------------------------------------------------

def test_interop_round_trip(small):
    jm, jp, tm, tp, rgb = small
    back = semantic_params_to(tp)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, jp)
    npz = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
           jax.tree_util.tree_flatten_with_path(jp)[0]}
    again = semantic_params_from(npz, "cpu")
    assert again.keys() == tp.keys()
    for k in tp:
        assert torch.equal(again[k], tp[k]), k


def test_save_params_crosses_both_ways(small, tmp_path):
    jm, jp, tm, tp, rgb = small
    # the port writes, JAX reads
    p1 = str(tmp_path / "port.npz")
    ts.save_params(p1, tp)
    _, fresh = js.init_segmenter(jax.random.PRNGKey(3), 32, 48, 3, 8)
    got = js.load_params(p1, fresh)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
        got, jp)
    # JAX writes, the port reads
    p2 = str(tmp_path / "jax.npz")
    js.save_params(p2, jp)
    _, template = ts.init_segmenter(32, 48, 3, 8, device="cpu")
    back = ts.load_params(p2, template)
    for k in tp:
        assert torch.equal(back[k], tp[k]), k
    # the committed artifacts load unchanged
    model, params, meta = entry.load_segmenter(entry.SEMANTIC4, "cpu")
    assert meta["num_classes"] == 4 and meta["net_width"] == 16
    npz = np.load(entry.SEMANTIC4)
    key = "['params']['ConvBN_3']['Conv_0']['kernel']"
    np.testing.assert_array_equal(params["ConvBN_3.Conv_0.weight"].numpy(),
                                  npz[key].transpose(3, 2, 0, 1))


# ---------------------------------------------------------------------------
# the point cloud, the colour map, the train step
# ---------------------------------------------------------------------------

def test_segmentation_to_pointcloud_exact():
    rng = np.random.default_rng(4)
    depth = rng.uniform(0.0, 6.0, (24, 32)).astype(np.float32)
    depth[rng.uniform(size=depth.shape) < 0.1] = 0.0
    mask = rng.integers(0, 5, (24, 32)).astype(np.int32)
    for keep in (None, [2], [1, 3]):
        want, wv = js.segmentation_to_pointcloud(
            jnp.asarray(depth), jnp.asarray(mask), 20.0, 21.0, 16.0, 12.0,
            keep_classes=keep, depth_scale=0.5)
        got, gv = ts.segmentation_to_pointcloud(
            torch.from_numpy(depth), torch.from_numpy(mask), 20.0, 21.0, 16.0,
            12.0, keep_classes=keep, depth_scale=0.5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_colorize_and_class_map_csv(tmp_path):
    path = tmp_path / "colors.csv"
    path.write_text("color;description\n70 130 180;SKY\n0 0 255;PERSON\n"
                    "\n107 142 35;VEGETATION\n")
    assert ts.load_class_map_csv(str(path))[0] == js.load_class_map_csv(
        str(path))[0]
    names, colors = ts.load_class_map_csv(str(path))
    np.testing.assert_array_equal(colors, js.load_class_map_csv(str(path))[1])
    mask = np.random.default_rng(5).integers(-1, 5, (6, 7)).astype(np.int32)
    want = np.asarray(js.colorize_classes(jnp.asarray(mask), colors))
    got = ts.colorize_classes(torch.from_numpy(mask), colors).numpy()
    np.testing.assert_array_equal(got, want)


def test_first_train_loss_matches_jax():
    """The JAX train test's task (32×32, 3 classes, width 8): the first
    step's loss from the same weights, within 1e-5 relative; and the loss
    with class weights and ignored pixels."""
    rgb, labels = entry.semantic_train_task()
    jm, jp = js.init_segmenter(jax.random.PRNGKey(0), 32, 32, 3, 8)
    tm, _ = ts.init_segmenter(32, 32, 3, 8, device="cpu")
    tp = semantic_params_from(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    init_opt, step = js.make_train_step(jm, learning_rate=3e-3)
    _, _, want = step(jp, init_opt(jp), jnp.asarray(rgb), jnp.asarray(labels))
    t_init, t_step = ts.make_train_step(tm, learning_rate=3e-3)
    new, state, got = t_step(tp, t_init(tp), torch.from_numpy(rgb),
                             torch.from_numpy(labels))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert state["count"] == 1 and new.keys() == tp.keys()
    assert any(not torch.equal(new[k], tp[k]) for k in tp)
    lab = labels.copy()
    lab[:, :4] = 255
    cw = np.array([0.5, 1.0, 2.0], np.float32)
    want = jax.jit(lambda p: js.softmax_ce_loss(
        jm, p, jnp.asarray(rgb), jnp.asarray(lab), class_weights=cw))(jp)
    with torch.no_grad():
        got = ts.softmax_ce_loss(tm, tp, torch.from_numpy(rgb),
                                 torch.from_numpy(lab), class_weights=cw)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


def test_train_losses_track_jax(golden):
    """Twelve Adam steps on the JAX train test's task from JAX's initial
    weights (the golden's, equal to ``PRNGKey(0)``'s here): each loss within
    2 % of JAX's, and the loss falls ≥ 10 %; a schedule is called with the
    step count from 0."""
    rgb, labels = entry.semantic_train_task()
    tm, _ = ts.init_segmenter(32, 32, 3, 8, device="cpu")
    params = semantic_params_from(
        {k[len("train_init"):]: v for k, v in golden.items()
         if k.startswith("train_init")}, "cpu")
    _, jp = js.init_segmenter(jax.random.PRNGKey(0), 32, 32, 3, 8)
    for k, v in semantic_params_from(
            jax.tree_util.tree_map(np.asarray, jp), "cpu").items():
        assert torch.equal(params[k], v), k
    seen = []

    def lr(count):
        seen.append(count)
        return 3e-3

    init_opt, step = ts.make_train_step(tm, learning_rate=lr)
    state = init_opt(params)
    losses = []
    for _ in range(12):
        params, state, loss = step(params, state, torch.from_numpy(rgb),
                                   torch.from_numpy(labels))
        losses.append(float(loss))
    want = golden["train_losses"]
    np.testing.assert_allclose(losses, want, rtol=0.02)
    assert losses[-1] < 0.9 * losses[0]
    assert seen == list(range(12))


# ---------------------------------------------------------------------------
# the 19-class artifact at full width, and the reroute chain, on the golden
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full(golden):
    sc = entry.semantic_scenario(device="cpu")
    with torch.no_grad():
        rgb = torch.from_numpy(sc.rgb)
        logits0 = sc.model(rgb[:1])[0].numpy()
        masks = ts.infer_classes(sc.model, sc.params, rgb).numpy()
    return sc, logits0, masks


def test_golden_frames_are_the_scenario(golden, full):
    sc, _, _ = full
    # numpy's vectorized trigonometry may round otherwise on another CPU
    sums = sc.rgb.astype(np.float64).sum(axis=(1, 2, 3))
    np.testing.assert_allclose(sums, golden["rgb_sums"], rtol=1e-6)
    assert sc.meta["num_classes"] == 19 and sc.meta["net_width"] == 48
    assert sum(p.numel() for p in sc.params.values()) > 1.3e6


def test_full_width_logits_match_golden(golden, full):
    _, logits0, _ = full
    assert logits0.shape == golden["logits0"].shape == (120, 160, 19)
    np.testing.assert_allclose(logits0, golden["logits0"], rtol=0,
                               atol=LOGITS_TOL)


def test_full_width_masks_match_golden(golden, full):
    """Equal wherever JAX's top-two gap exceeds twice the logits tolerance;
    the flips elsewhere ≤ 0.05 % of the pixels; mIoU within 0.005."""
    sc, _, masks = full
    want = golden["masks"].astype(np.int32)
    decided = golden["gap"].astype(np.float32) > 2 * LOGITS_TOL
    flips = masks != want
    assert not (flips & decided).any(), int((flips & decided).sum())
    assert flips.mean() <= FLIP_SHARE, int(flips.sum())
    score = td.miou(masks, sc.labels, num_classes=19)
    assert abs(score - float(golden["miou"])) <= 0.005
    meta = sc.meta
    assert score >= 0.30 and score >= 0.8 * meta["miou_heldout"] - 0.1


def test_reroute_chain_matches_golden(golden):
    """The 4-class chain: the class mask as JAX's but for a few boundary
    pixels, > 90 % of the detected zone points in the true zone, the
    straight baseline plan equal to JAX's and the zone plan bending
    > 1.2 m inside x ∈ (2, 5), as JAX's does."""
    r = entry.run_semantic_reroute("cpu")
    want = golden["reroute_mask"].astype(np.int32)
    assert (r["pred"] != want).mean() <= 1e-3
    n = int(r["in_zone"].sum())
    assert abs(n - int(golden["reroute_zone_points"])) <= 0.02 * n
    assert len(r["zone"]) > 50 and r["in_zone"].mean() > 0.9
    assert r["ok_free"] and r["ok_zone"]
    np.testing.assert_array_equal(r["ids_free"], golden["reroute_ids_free"])
    assert entry.reroute_bend(r["ground"], r["ids_free"]) < 0.3
    assert entry.reroute_bend(r["ground"], r["ids_zone"]) > 1.2
    assert entry.reroute_bend(r["ground"], golden["reroute_ids_zone"]) > 1.2


# ---------------------------------------------------------------------------
# the copies
# ---------------------------------------------------------------------------

def test_semantic_data_copy_equals_original():
    cam = td.CameraIntrinsics()
    assert cam == jd.CameraIntrinsics()
    np.testing.assert_array_equal(td.CLASS_COLORS, jd.CLASS_COLORS)
    for kw in ({}, {"n_boxes": 0, "zones": [(3.0, -0.5, 1.6, 1.2)],
                    "pitch_jitter": 0.0}):
        a = td.render_scene(np.random.default_rng(2), cam, **kw)
        b = jd.render_scene(np.random.default_rng(2), cam, **kw)
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert a[3] == b[3]
        np.testing.assert_array_equal(a[4][0], b[4][0])
        assert a[4][1] == b[4][1]
    rgb_a, lab_a = td.make_batch(np.random.default_rng(3), 3, cam)
    rgb_b, lab_b = jd.make_batch(np.random.default_rng(3), 3, cam)
    np.testing.assert_array_equal(rgb_a, rgb_b)
    np.testing.assert_array_equal(lab_a, lab_b)
    pred = np.random.default_rng(4).integers(0, 4, lab_a.shape)
    assert td.miou(pred, lab_a) == jd.miou(pred, lab_a)
    pts = np.random.default_rng(5).normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        td.camera_to_world(pts, [0.0, 0.0, 1.0], -0.2),
        jd.camera_to_world(pts, [0.0, 0.0, 1.0], -0.2))
    src = [[409, 484], [878, 488], [1273, 646], [0, 638]]
    dst = [[0, 0], [1000, 0], [1000, 950], [0, 950]]
    m = td.perspective_matrix(src, dst)
    np.testing.assert_array_equal(m, jd.perspective_matrix(src, dst))
    img = np.zeros((70, 130), np.int32)
    img[48:65, 40:128] = 7
    for x, y in zip(td.warp_nearest(img, m, 95, 100),
                    jd.warp_nearest(img, m, 95, 100)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(td.bev_class_grid(lab_a[0], cam, 1.0, -0.2),
                    jd.bev_class_grid(lab_a[0], cam, 1.0, -0.2)):
        np.testing.assert_array_equal(x, y)


def test_semantic_scene19_copy_equals_original():
    assert ts19.CLASS_NAMES == js19.CLASS_NAMES
    for preset in ("TRAIN_PRESET", "EVAL_PRESET"):
        assert (dataclasses.asdict(getattr(ts19, preset))
                == dataclasses.asdict(getattr(js19, preset)))
    for preset in ("TRAIN_PRESET", "EVAL_PRESET"):
        a = ts19.render_scene19(np.random.default_rng(6), 60, 80,
                                getattr(ts19, preset), return_pose=True)
        b = js19.render_scene19(np.random.default_rng(6), 60, 80,
                                getattr(js19, preset), return_pose=True)
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert a[3] == b[3]
    for x, y in zip(ts19.make_batch19(np.random.default_rng(8), 2, 48, 64),
                    js19.make_batch19(np.random.default_rng(8), 2, 48, 64)):
        np.testing.assert_array_equal(x, y)


def test_artifact_metadata_matches_scenario():
    with open(entry.SEMANTIC19 + ".json") as f:
        meta = json.load(f)
    assert meta["image_hw"] == [240, 320]
    assert meta["classes"] == ts19.CLASS_NAMES
