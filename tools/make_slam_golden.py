"""Write the JAX package's mapping run as a golden file for the PyTorch
port.

Runs ``dddmr_navigation_tpu.slam.MappingSession`` at ``SlamConfig()``'s
full width (a 16×1000 range image, 12 + 6 Gauss-Newton iterations, submap
pads of 2,048 and 4,096, a 256-keyframe graph) through the port's
``entry.slam_scenario()``: ``bench.py::bench_slam``'s world, 56 scans on a
3 m circle at 0.4 m a scan (1.15 laps), each simulated by the port's own
``lidar_sim`` copy, so the golden file and the port start from the same
arrays. The JAX session makes 20 keyframes and closes loops 16-19 → 0-3.

Saves, compressed, to
``dddmr_navigation_tpu_torch/testdata/slam_golden.npz``:

* ``true_pos`` (56, 3), ``true_yaw`` (56,): the loop (the lidar in the
  world); ``scan_t``, ``scan_points``, ``scan_mask``: one scan (the first
  loop closure's), against which the regenerated scans are checked (the
  scans are not stored);
* per scan (``interop.pack_ticks``), the state the scan started from
  (``state_`` + ``interop.mapping_fields`` names, keyframes and submap
  left out: the keyframes are stored once, the submap is rebuilt from the
  state) and its outputs (``out_`` +): ``pos``, ``quat`` after the scan,
  ``keyframe`` (the scan added one), ``n_keyframes``, ``n_edges``,
  ``n_loops``, ``has_odom``/``odom_pos``/``odom_quat`` (the pose after
  scan-to-keyframe odometry, composed into the map frame),
  ``has_refined``/``refined_pos``/``refined_quat`` (after scan-to-map
  refinement), ``cand``/``found`` (the loop candidate), ``has_icp``/
  ``icp_pos``/``icp_quat``/``icp_fitness``, ``has_graph``/``graph_pos``/
  ``graph_quat`` (the graph after its optimization);
* the keyframes of the final session (``interop.keyframe_fields``:
  ``kf_sharp``, ... — each keyframe scan's frontend output — and the
  patched grounds ``kf_ground``/``kf_ground_edge`` with lengths);
* ``saved_poses`` (20, 8): the rows of ``poses.pcd`` the JAX session's
  ``save`` writes at the end.

``chip_smoke.py`` and ``tests/test_torch_slam_golden.py`` hold the port to
it. ~4 minutes on an 8-core CPU (the JAX session takes ~2.5-3 s a scan,
its four loop closures ~10 s each), and the file is 1.25 MB:

    JAX_PLATFORMS=cpu python tools/make_slam_golden.py
"""
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                   "slam_golden.npz")

from dddmr_navigation_tpu_torch.interop import (  # noqa: E402
    keyframe_fields, mapping_fields, pack_ticks)


def jax_mapping_run(sc, log=None):
    """The JAX package's ``MappingSession`` over the scenario ``sc``
    (``entry.SlamScenario``). Returns (the session at the end, [per-scan
    record dict]). The session's device programs are wrapped to record
    their outputs (this process only)."""
    import dataclasses
    import numpy as np
    import jax.numpy as jnp
    from dddmr_navigation_tpu.config import SlamConfig
    from dddmr_navigation_tpu.slam import pipeline as jpipe
    from dddmr_navigation_tpu_torch import entry

    cfg = SlamConfig(**{f.name: getattr(sc.cfg, f.name)
                        for f in dataclasses.fields(sc.cfg)})
    seen = {}

    def recording(name, fn, keep):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            seen[name] = keep(a, k, out)
            return out
        return wrapped

    jpipe._map_refine = recording(
        "refine", jpipe._map_refine,
        lambda a, k, out: (a[-2], a[-1], out[0], out[1]))
    jpipe.icp_point2point = recording(
        "icp", jpipe.icp_point2point, lambda a, k, out: out)
    jpipe.pg.optimize_pose_graph = recording(
        "graph", jpipe.pg.optimize_pose_graph,
        lambda a, k, out: (out.pos, out.quat))
    jpipe.pg.detect_loop_candidate = recording(
        "cand", jpipe.pg.detect_loop_candidate, lambda a, k, out: out)

    sess = jpipe.MappingSession(cfg=cfg)
    recs = []
    for t in range(sc.scans):
        pts, mask = entry.slam_scan(sc, t)
        state = {f"state_{k}": v for k, v in
                 mapping_fields(sess, keyframes=False).items()
                 if not k.startswith("submap_")}
        kf0 = sess.n_keyframes
        seen.clear()
        t0 = time.perf_counter()
        p, q = sess.process_scan(jnp.asarray(pts), jnp.asarray(mask))
        dt = time.perf_counter() - t0
        z3, z4 = np.zeros(3, np.float32), np.zeros(4, np.float32)

        def arr(x):
            return np.asarray(x, np.float32)
        out = {"pos": arr(p), "quat": arr(q),
               "keyframe": np.bool_(sess.n_keyframes > kf0),
               "n_keyframes": np.int64(sess.n_keyframes),
               "n_edges": np.int64(sess.n_edges),
               "n_loops": np.int64(len(sess.loop_closures))}
        r = seen.get("refine")
        out.update(has_odom=np.bool_(r is not None),
                   odom_pos=arr(r[0]) if r else z3,
                   odom_quat=arr(r[1]) if r else z4,
                   has_refined=np.bool_(r is not None),
                   refined_pos=arr(r[2]) if r else z3,
                   refined_quat=arr(r[3]) if r else z4)
        c = seen.get("cand")
        out.update(cand=np.int64(c[0]) if c else np.int64(-1),
                   found=np.bool_(bool(c[1])) if c else np.bool_(False))
        i = seen.get("icp")
        out.update(has_icp=np.bool_(i is not None),
                   icp_pos=arr(i[0]) if i else z3,
                   icp_quat=arr(i[1]) if i else z4,
                   icp_fitness=np.float32(i[2]) if i else np.float32(0))
        gph = seen.get("graph")
        k = cfg.max_keyframes
        out.update(has_graph=np.bool_(gph is not None),
                   graph_pos=arr(gph[0]) if gph else np.zeros((k, 3),
                                                              np.float32),
                   graph_quat=arr(gph[1]) if gph else np.zeros((k, 4),
                                                               np.float32))
        rec = dict(state)
        rec.update({f"out_{k}": v for k, v in out.items()})
        recs.append(rec)
        if log:
            log(f"scan {t}: {dt:.2f} s, keyframes {sess.n_keyframes}, "
                f"edges {sess.n_edges}, loops {len(sess.loop_closures)}")
    return sess, recs


def main():
    import numpy as np
    from dddmr_navigation_tpu.state_estimation.submaps import (
        read_pose_graph)
    from dddmr_navigation_tpu_torch import entry

    t0 = time.perf_counter()
    sc = entry.slam_scenario()
    sess, recs = jax_mapping_run(sc, log=print)
    loop_t = next(t for t, r in enumerate(recs) if r["out_has_graph"])
    pts, mask = entry.slam_scan(sc, loop_t)
    with tempfile.TemporaryDirectory() as d:
        sess.save(d)
        saved = read_pose_graph(d).poses
    out = dict(true_pos=sc.true_pos, true_yaw=sc.true_yaw,
               scan_t=np.int64(loop_t), scan_points=pts, scan_mask=mask,
               saved_poses=np.asarray(saved, np.float32))
    out.update(pack_ticks(recs))
    out.update(keyframe_fields(sess))
    np.savez_compressed(OUT, **out)
    err = np.linalg.norm(recs[-1]["out_pos"][:2]
                         - entry.slam_truth(sc, sc.scans - 1)[0][:2])
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB) in "
          f"{time.perf_counter() - t0:.0f} s: {sess.n_keyframes} keyframes, "
          f"{sess.n_edges} edges, loops {sess.loop_closures}, final error "
          f"{err:.3f} m")


if __name__ == "__main__":
    main()
