"""Write the JAX package's global localization as a golden file for the
PyTorch port.

Runs ``dddmr_navigation_tpu.state_estimation.global_localization
.GlobalLocalization`` through the JAX package's own recovery test
(``tests/test_state_estimation.py::
test_global_localization_recovers_unknown_start``): the box world, a 0.2 m
submap, ``PRNGKey(3)``, 2,048 seed particles × 16 yaws, a ×0.75 shrink
every second tick down to 32 particles, 192 sharp features within 9 m, the
truth circling 0.5 m around (-2.5, 2.5); ticks 1, 2, ... until the filter
is fixed (at most 79). The scenario's world, settings and scans come from
the port's own builders (``dddmr_navigation_tpu_torch.entry
.global_localization_scenario``/``globalloc_inputs``), so the golden file
and the port start from the same arrays.

Saves, compressed, to
``dddmr_navigation_tpu_torch/testdata/globalloc_golden.npz``:

* ``node_idx``, ``yaw_idx`` (2,048,): the seed's ground nodes and yaw
  cells, replayed from the seed's keys;
* per tick (``interop.pack_ticks``; the per-particle arrays concatenated
  over ticks with their lengths under ``<key>__len``): the unit draws the
  update consumed, replayed from the filter's own key
  (``tools/make_config4_golden.py::jax_mcl_draws``; ``u``, ``res_pos``,
  ...), the MCL state the tick started from (``interop.mcl_fields``
  names: ``mcl_particles_pos``, ...), the inputs (``odom_prev_pos``,
  ``odom_prev_quat``, ``odom_pos``, ``odom_quat``, ``flat``, ``flat_m``,
  ``sharp``, ``sharp_m``), the truth (``true_pos``), and the outputs:
  ``n`` (the particles the update ran at), ``size`` and ``fix_cnt``
  after the tick, ``fixed``, ``pose_pos``, ``pose_quat`` and
  ``match_ratio``.

``chip_smoke.py`` and ``tests/test_torch_globalloc_golden.py`` hold the
port to it. ~2 minutes on a 2-core CPU:

    JAX_PLATFORMS=cpu python tools/make_globalloc_golden.py
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                   "globalloc_golden.npz")

from dddmr_navigation_tpu_torch.interop import (  # noqa: E402
    mcl_fields, pack_ticks)
from tools.make_config4_golden import jax_mcl_draws  # noqa: E402


def jax_seed_draws(key, num_nodes: int, num_start: int, yaw_samples: int):
    """The node and yaw-cell draws ``seed_global_state(key, ...)`` makes
    (its split of ``key`` into (key, k_node, k_yaw)), as numpy."""
    import jax
    import numpy as np
    _, k_node, k_yaw = jax.random.split(key, 3)
    return (np.asarray(jax.random.randint(k_node, (num_start,), 0,
                                          num_nodes)),
            np.asarray(jax.random.randint(k_yaw, (num_start,), 0,
                                          yaw_samples)))


def jax_global_chain(sc, key_seed: int = 3, log=None):
    """The JAX package's global localization over the scenario ``sc``
    (``entry.GlobalLocScenario``) from ``PRNGKey(key_seed)``: returns
    (seed node indices, seed yaw cells, [per-tick record dict])."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from dddmr_navigation_tpu.config import MCLConfig
    from dddmr_navigation_tpu.geometry import quat_from_yaw
    from dddmr_navigation_tpu.state_estimation import build_submap_context
    from dddmr_navigation_tpu.state_estimation.global_localization import (
        GlobalLocalization)
    from dddmr_navigation_tpu_torch import entry
    import dataclasses

    cfg = MCLConfig(**{f.name: getattr(sc.cfg, f.name)
                       for f in dataclasses.fields(sc.cfg)})
    ctx = build_submap_context(sc.map_pts, sc.ground_pts, cfg, res=sc.res)
    key = jax.random.PRNGKey(key_seed)
    gl = GlobalLocalization(cfg, ctx, key, sc.ground_pts,
                            num_start=sc.num_start,
                            yaw_samples=sc.yaw_samples,
                            shrink_every=sc.shrink_every)
    node_idx, yaw_idx = jax_seed_draws(key, len(sc.ground_pts),
                                       sc.num_start, sc.yaw_samples)
    assert np.array_equal(np.asarray(gl.state.particles.pos),
                          sc.ground_pts[node_idx]), "seed replay differs"
    records = []
    for t in range(1, sc.ticks):
        x = entry.globalloc_inputs(sc, t)
        q_prev = quat_from_yaw(jnp.asarray(x["odom_prev_yaw"]))
        q_now = quat_from_yaw(jnp.asarray(x["odom_yaw"]))
        rec = {k: v[0] for k, v in jax_mcl_draws(gl.state.key[None],
                                                 gl.size).items()}
        rec.update(mcl_fields(gl.state))
        rec.update(odom_prev_pos=x["odom_prev_pos"],
                   odom_prev_quat=np.asarray(q_prev),
                   odom_pos=x["odom_pos"], odom_quat=np.asarray(q_now),
                   flat=x["flat"], flat_m=x["flat_m"], sharp=x["sharp"],
                   sharp_m=x["sharp_m"], true_pos=x["odom_pos"],
                   n=np.int64(gl.size))
        out = gl.step(jnp.asarray(x["odom_prev_pos"]), q_prev,
                      jnp.asarray(x["odom_pos"]), q_now, jnp.asarray(0.25),
                      jnp.asarray(x["flat"]), jnp.asarray(x["flat_m"]),
                      jnp.asarray(x["sharp"]), jnp.asarray(x["sharp_m"]),
                      jnp.ones(x["sharp"].shape[0]))
        rec.update(size=np.int64(gl.size), fix_cnt=np.int64(gl.fix_cnt),
                   fixed=np.bool_(gl.fixed),
                   pose_pos=np.asarray(out.pose_pos),
                   pose_quat=np.asarray(out.pose_quat),
                   match_ratio=np.asarray(out.match_ratio_max))
        records.append(rec)
        if log:
            log(t, rec)
        if gl.fixed:
            break
    return node_idx, yaw_idx, records


def main():
    import numpy as np
    from dddmr_navigation_tpu_torch import entry

    t0 = time.time()
    sc = entry.global_localization_scenario()

    def log(t, rec):
        err = float(np.linalg.norm(rec["pose_pos"][:2] - rec["true_pos"][:2]))
        print(f"tick {t}: {time.time() - t0:.1f} s; particles {rec['n']} -> "
              f"{rec['size']}, fix_cnt {rec['fix_cnt']}, error {err:.3f} m",
              flush=True)
    node_idx, yaw_idx, records = jax_global_chain(sc, log=log)
    np.savez_compressed(OUT, node_idx=node_idx, yaw_idx=yaw_idx,
                        **pack_ticks(records))
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB), "
          f"{len(records)} ticks, fixed {bool(records[-1]['fixed'])}, in "
          f"{time.time() - t0:.0f} s")


if __name__ == "__main__":
    main()
