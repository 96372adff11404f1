"""How close MCL keeps to the truth on the map the mapping run saves, for
the JAX package (keys ``PRNGKey(0..n-1)``) and for the port on the CPU
(``torch.Generator`` seeds ``0..n-1``).

The map is the JAX run's final state of
``dddmr_navigation_tpu_torch/testdata/slam_golden.npz`` (its last scan
replayed by the port, teacher-forced, and saved; the port's ``save``
writes what JAX's does). The pass is ``examples/run_slam_mcl.py``'s
localization pass as ``entry.run_slam_localization`` runs it: 48
particles from the true start, odometry equal to the truth, 10 ticks
along scans 1-10 of the mapped route, the scan split at -0.4 m into flat
and sharp features (the first 512 of each). Prints, per run, the largest
and the last xy error, and over the runs the share of estimates within
0.5 m, the median and the largest final error.

    JAX_PLATFORMS=cpu python tools/slam_localization_rate.py [n] [port] [jax]

(~30 s for the map, ~1 s a JAX key after a compile, ~4 s a port seed on
an 8-core CPU.)
"""
import functools
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def saved_map(sc, out_dir):
    """The golden run's final map, written to ``out_dir``."""
    import numpy as np
    from dddmr_navigation_tpu_torch import entry
    from dddmr_navigation_tpu_torch.interop import port_mapping_state, tick_of
    g = dict(np.load(os.path.join(ROOT, "dddmr_navigation_tpu_torch",
                                  "testdata", "slam_golden.npz")))
    n = sc.scans
    sess = port_mapping_state(tick_of(g, n - 1, prefix="state_"), sc.cfg,
                              "cpu", keyframes=g)
    sess.process_scan(*entry.slam_scan(sc, n - 1))
    sess.save(out_dir)


def jax_errors(sc, out_dir, key: int):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from dddmr_navigation_tpu.config import MCLConfig
    from dddmr_navigation_tpu.geometry import quat_from_yaw
    from dddmr_navigation_tpu.state_estimation import (
        SubmapManager, init_mcl, mcl_update, read_pose_graph)
    from dddmr_navigation_tpu_torch import entry
    cfg = MCLConfig(num_particles=48)
    mgr = SubmapManager(graph=read_pose_graph(out_dir), cfg=cfg)
    mgr.initialize([0.0, 0.0, 0.0])
    step = jax.jit(functools.partial(mcl_update, cfg))
    state = init_mcl(jax.random.PRNGKey(key), cfg, jnp.zeros(3),
                     jnp.asarray([0.0, 0.0, 0.0, 1.0]))
    errs = []
    for t in range(1, entry.SLAM_LOC_TICKS + 1):
        pp, py = entry.slam_truth(sc, t - 1)
        cp, cy = entry.slam_truth(sc, t)
        feats = entry.slam_localization_features(sc, t)
        state, out = step(mgr.current(cp), state, jnp.asarray(pp),
                          quat_from_yaw(jnp.float32(py)), jnp.asarray(cp),
                          quat_from_yaw(jnp.float32(cy)),
                          jnp.float32(entry.SLAM_LOC_DT),
                          *map(jnp.asarray, feats),
                          jnp.ones(entry.SLAM_LOC_POINTS))
        errs.append(float(np.linalg.norm(np.asarray(out.pose_pos)[:2]
                                         - cp[:2])))
    return errs


def summary(name, runs):
    import numpy as np
    a = np.asarray(runs)
    for i, r in enumerate(a):
        print(f"{name} {i}: largest {r.max():.3f} m, last {r[-1]:.3f} m")
    print(f"{name}: {len(a)} runs, {100 * (a < 0.5).mean():.1f}% of "
          f"estimates within 0.5 m, final error median "
          f"{np.median(a[:, -1]):.3f} m, largest {a[:, -1].max():.3f} m")


def main():
    import torch
    from dddmr_navigation_tpu_torch import entry
    from dddmr_navigation_tpu_torch.state_estimation.submaps import (
        read_pose_graph)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    which = sys.argv[2:] or ["port", "jax"]
    sc = entry.slam_scenario()
    with tempfile.TemporaryDirectory() as d:
        saved_map(sc, d)
        if "port" in which:
            graph = read_pose_graph(d)
            summary("port", [[e for _, e, _ in run] for run in
                             entry.run_slam_localization(
                                 sc, graph, [torch.Generator().manual_seed(s)
                                             for s in range(n)],
                                 device="cpu")])
        if "jax" in which:
            summary("jax", [jax_errors(sc, d, k) for k in range(n)])


if __name__ == "__main__":
    main()
