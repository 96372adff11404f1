"""Write the JAX package's semantic segmentation as a golden file for the
PyTorch port.

Runs ``dddmr_navigation_tpu.perception.semantic`` on the CPU, as the port's
parity tests and ``chip_smoke.py`` hold the port to it:

* the committed 19-class artifact (``artifacts/semantic_ddrnet19.npz``: net
  width 48, 240×320) on the 8 EVAL-family frames of the JAX test's seed
  (``semantic_scene19.make_batch19``, seed 555, one batch of 8):
  ``masks`` (8, 240, 320) uint8, ``infer_classes``'s class ids;
  ``gap`` (8, 240, 320) f16, each pixel's top-two gap of the logits the
  argmax reads (clipped at 4: only small gaps matter); ``logits0``
  (120, 160, 19) f32, the model's output for frame 0; ``miou`` and
  ``miou_frames`` against the true labels; ``rgb_sums`` (8,) f64, a
  checksum of the frames (the images are regenerated from the seed through
  the port's copy of the renderer, not stored);
* the 4-class reroute chain of ``tests/test_semantic_e2e.py`` (the
  ``semantic_ddrnet.npz`` artifact, ``render_scene`` seed 5, zone
  (3.5, 0, 2, 2)): ``reroute_mask`` (96, 128) uint8, ``reroute_zone_points``
  (the class-2 points in the true zone), ``reroute_ids_free`` and
  ``reroute_ids_zone`` (both plans' node ids);
* ``train_losses`` (12,): the JAX train test's synthetic task
  (``tests/test_perception_layers.py``: 32×32, 3 classes, width 8, lr 3e-3,
  ``PRNGKey(0)`` weights, ``default_rng(0)`` data) step by step, and its
  initial weights (``train_init`` + the flax key of each, as the npz of
  ``save_params`` names them), so that the card starts from them.

Saves, compressed, to ``dddmr_navigation_tpu_torch/testdata/
semantic_golden.npz`` (~1.7 MB). About a minute on an 8-core CPU:

    JAX_PLATFORMS=cpu python tools/make_semantic_golden.py
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax                                              # noqa: E402
import jax.numpy as jnp                                 # noqa: E402

from dddmr_navigation_tpu.config import GlobalPlannerConfig  # noqa: E402
from dddmr_navigation_tpu.io.maps import flat_ground_map  # noqa: E402
from dddmr_navigation_tpu.perception import semantic_scene19 as s19  # noqa
from dddmr_navigation_tpu.perception.layers import no_entry_dgraph  # noqa
from dddmr_navigation_tpu.perception.semantic import (  # noqa: E402
    init_segmenter, infer_classes, load_params, make_train_step,
    segmentation_to_pointcloud)
from dddmr_navigation_tpu.perception.semantic_data import (  # noqa: E402
    CameraIntrinsics, camera_to_world, miou, render_scene)
from dddmr_navigation_tpu.planning.global_.graph import (  # noqa: E402
    build_ground_graph)
from dddmr_navigation_tpu.planning.global_.planner import (  # noqa: E402
    plan_on_graph)

from dddmr_navigation_tpu_torch import entry            # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dddmr_navigation_tpu_torch", "testdata",
    "semantic_golden.npz")
GAP_CLIP = 4.0


def load(path):
    meta = json.load(open(path + ".json"))
    h, w = meta["image_hw"]
    model, tmpl = init_segmenter(jax.random.PRNGKey(0), h, w,
                                 meta["num_classes"], meta["net_width"])
    return model, load_params(path, tmpl), meta


def full_logits(model, params, rgb):
    """``infer_classes``'s logits before its argmax."""
    @jax.jit
    def f(p, x):
        logits = model.apply(p, x)
        return jax.image.resize(
            logits, (x.shape[0], x.shape[1], x.shape[2], logits.shape[-1]),
            "bilinear")
    return np.asarray(f(params, rgb))


def semantic19(out):
    model, params, _ = load(entry.SEMANTIC19)
    rng = np.random.default_rng(entry.SEMANTIC_SEED)
    rgb, labels = s19.make_batch19(rng, entry.SEMANTIC_FRAMES, 240, 320,
                                   preset=s19.EVAL_PRESET)
    x = jnp.asarray(rgb)
    masks = np.asarray(infer_classes(model, params, x))
    full = full_logits(model, params, x)
    top2 = np.sort(full, axis=-1)[..., -2:]
    out["masks"] = masks.astype(np.uint8)
    out["gap"] = np.minimum(top2[..., 1] - top2[..., 0],
                            GAP_CLIP).astype(np.float16)
    out["logits0"] = np.asarray(jax.jit(model.apply)(params, x[:1]))[0]
    out["miou"] = np.float64(miou(masks, labels, num_classes=19))
    out["miou_frames"] = np.array(
        [miou(masks[i], labels[i], num_classes=19) for i in range(len(rgb))])
    out["rgb_sums"] = rgb.astype(np.float64).sum(axis=(1, 2, 3))
    print("19-class mIoU", float(out["miou"]))


def reroute(out):
    model, params, _ = load(entry.SEMANTIC4)
    cam = CameraIntrinsics()
    rng = np.random.default_rng(entry.REROUTE_SEED)
    zone = entry.REROUTE_ZONE
    rgb, depth, _, _, (origin, pitch) = render_scene(
        rng, cam, n_boxes=0, zones=[zone], pitch_jitter=0.0)
    pred = np.asarray(infer_classes(model, params, jnp.asarray(rgb[None])))[0]
    cloud, valid = segmentation_to_pointcloud(
        jnp.asarray(depth), jnp.asarray(pred), cam.fx, cam.fy, cam.cx,
        cam.cy, keep_classes=[2])
    pts = camera_to_world(np.asarray(cloud)[np.asarray(valid)][:, :3],
                          origin, pitch)
    in_zone = ((np.abs(pts[:, 0] - zone[0]) <= zone[2] / 2 + 0.4)
               & (np.abs(pts[:, 1] - zone[1]) <= zone[3] / 2 + 0.4)
               & (np.abs(pts[:, 2]) <= 0.2))
    ground = flat_ground_map(16, 8, 0.25)
    ground[:, 0] += 7.0
    g = len(ground)
    zone_pts = pts[in_zone].astype(np.float32)
    field = no_entry_dgraph(
        jnp.asarray(ground), jnp.ones((g,), bool), jnp.asarray(zone_pts),
        jnp.ones((len(zone_pts),), bool), inflation_distance=1.0,
        max_obstacle_distance=9999.0)
    graph = build_ground_graph(ground, radius=0.5, k_max=16)
    gcfg = GlobalPlannerConfig()

    def plan(dgraph):
        res = jax.jit(lambda d: plan_on_graph(
            gcfg, jnp.asarray(graph.nbr_idx), jnp.asarray(graph.nbr_dist),
            jnp.asarray(graph.nbr_valid), jnp.asarray(ground),
            jnp.ones((g,), bool), d, jnp.zeros((g,)),
            jnp.asarray(graph.avg_intensity),
            jnp.asarray(entry.REROUTE_START, jnp.float32),
            jnp.asarray(entry.REROUTE_GOAL, jnp.float32),
            inscribed_radius=0.5, inflation_descending_rate=2.0))(dgraph)
        assert bool(res.ok)
        return np.asarray(res.node_ids)[np.asarray(res.node_valid)]

    out["reroute_mask"] = pred.astype(np.uint8)
    out["reroute_zone_points"] = np.int64(in_zone.sum())
    out["reroute_in_zone"] = np.float64(in_zone.mean())
    out["reroute_ids_free"] = plan(jnp.full((g,), 9999.0)).astype(np.int32)
    out["reroute_ids_zone"] = plan(field).astype(np.int32)
    print("reroute zone points", int(in_zone.sum()))


def train(out):
    model, params = init_segmenter(jax.random.PRNGKey(0), height=32,
                                   width=32, num_classes=3, net_width=8)
    rng = np.random.default_rng(0)
    rgb = rng.uniform(0, 1, (4, 32, 32, 3)).astype(np.float32)
    labels = (rgb.mean(-1) * 3).astype(np.int32).clip(0, 2)
    for k, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["train_init" + jax.tree_util.keystr(k)] = np.asarray(v)
    init_opt, step = make_train_step(model, learning_rate=3e-3)
    opt_state = init_opt(params)
    losses = []
    for _ in range(12):
        params, opt_state, loss = step(params, opt_state, jnp.asarray(rgb),
                                       jnp.asarray(labels))
        losses.append(float(loss))
    out["train_losses"] = np.array(losses)
    print("train losses", losses[0], losses[-1])


def main():
    out = {}
    semantic19(out)
    reroute(out)
    train(out)
    np.savez_compressed(OUT, **out)
    print(OUT, os.path.getsize(OUT), "bytes")


if __name__ == "__main__":
    main()
