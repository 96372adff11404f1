"""Write the JAX package's full-fidelity fleet chain (bench config 4) as a
golden file for the PyTorch port.

Runs ``dddmr_navigation_tpu.parallel.fleet.fleet_full_tick`` at
``bench.py::bench_config4``'s full width (64 robots on
``flat_ground_map(12, 8, 0.25)`` inside the warehouse walls; a 64×64×24
window, 512 marked voxels, 2,048 window nodes, 2,048 scan points; 16×16
samples of 40 steps, 512 obstacles, near-K 128; turning weight 0.1,
256 long edges, 8 LOS samples, 192 relaxation iterations; MCL with 60
particles in ``corr`` mode; ``MoveBaseConfig()``) on the CPU: the cold
tick and 10 warm ticks with the bench's odometry drift, closed loop. The
configuration, world and start state come from the port's own builders
(``dddmr_navigation_tpu_torch.entry.config4_*``), so the golden file and
the port start from the same arrays.

Saves, compressed, to
``dddmr_navigation_tpu_torch/testdata/config4_golden.npz``:

* the MCL's initial unit normals (``init_pos_n``, ``init_rpy_n``,
  (B, N, 3)), and per tick (T = 11) the unit draws each update consumed,
  replayed from the filters' own keys (:func:`jax_mcl_draws`):
  ``u`` (T, B), ``res_pos``/``res_rpy``/``exp_pos``/``exp_rpy``
  (T, B, N, 3), ``odom`` (T, B, N, 4);
* per tick, the true pose and twist the tick started from (``pos``,
  ``quat``, ``v``, ``w``), the MCL state it started from (``mcl_`` and
  the field's path: ``mcl_particles_pos``, ``mcl_state_prev_pos``,
  ``mcl_f_pos_x``, ..., see ``interop.mcl_fields``) and its outputs
  ``decision``, ``cmd_source``, ``ps_simple``, ``ps_rotate``, ``plan_ok``,
  ``wf_iters``, ``vx``, ``wz``, ``plan_pos``, ``plan_yaw`` and
  ``mcl_err``.

``chip_smoke.py`` and ``tests/test_torch_fleet_full.py`` hold the port to
it. ~3 minutes on a 2-core CPU:

    JAX_PLATFORMS=cpu python tools/make_config4_golden.py
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                   "config4_golden.npz")

from dddmr_navigation_tpu_torch.interop import DRAW_KEYS, mcl_fields  # noqa: E402


def jax_init_normals(seed: int, b: int, n: int):
    """The unit normals ``init_fleet_full_state(seed=seed)`` spreads robot
    i's particles with (``init_mcl``'s split of ``PRNGKey(seed + i)``,
    then ``pf._pose_noise``'s), as numpy (B, N, 3) × 2."""
    import jax
    import numpy as np

    pos, rpy = [], []
    for i in range(b):
        _, sub = jax.random.split(jax.random.PRNGKey(seed + i))
        kp, kr = jax.random.split(sub)
        pos.append(np.asarray(jax.random.normal(kp, (n, 3))))
        rpy.append(np.asarray(jax.random.normal(kr, (n, 3))))
    return np.stack(pos), np.stack(rpy)


def jax_mcl_draws(keys, n: int) -> dict:
    """The unit draws ``mcl_update`` makes from each robot's key (B, 2),
    replaying its splits (`mcl.py:120`, `pf.py:53,181-183,224`): the
    resampling's unit uniform (``uniform(ku, (), 0, pstep)`` is
    ``max(0, u·pstep)``) and normals, the expansion's normals and the
    four odometry-noise normals. Returns numpy arrays by
    ``interop.DRAW_KEYS``."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    def one(key):
        _, k_res, k_noise, k_exp = jax.random.split(key, 4)
        ku, kn = jax.random.split(k_res)
        kp, kr = jax.random.split(kn)
        ep, er = jax.random.split(k_exp)
        ks = jax.random.split(k_noise, 4)
        odom = jnp.stack([jax.random.normal(k, (n,)) for k in ks], axis=-1)
        return (jax.random.uniform(ku, ()), jax.random.normal(kp, (n, 3)),
                jax.random.normal(kr, (n, 3)), jax.random.normal(ep, (n, 3)),
                jax.random.normal(er, (n, 3)), odom)

    out = jax.jit(jax.vmap(one))(keys)
    return {k: np.asarray(v) for k, v in zip(DRAW_KEYS, out)}


def main():
    import numpy as np
    import jax
    import jax.numpy as jnp
    from functools import partial

    from dddmr_navigation_tpu.control.fused import (
        build_fused_map, make_fused_tick)
    from dddmr_navigation_tpu.parallel.fleet import (
        init_fleet_full_state, fleet_full_tick)
    from dddmr_navigation_tpu.state_estimation.likelihood import (
        build_submap_context)
    from dddmr_navigation_tpu_torch import entry

    t0 = time.time()
    cfg, mb, mcl_cfg = entry.config4_config()
    w = entry.config4_world()
    b, n = entry.CONFIG4_ROBOTS, mcl_cfg.num_particles
    fmap = build_fused_map(cfg, w.ground, w.walls)
    submap = build_submap_context(w.walls, w.ground, mcl_cfg)
    _, spec, ri, params = make_fused_tick(cfg)
    state = init_fleet_full_state(cfg, len(w.ground), w.positions, w.quats,
                                  localize=True, mcl_cfg=mcl_cfg)
    init_pos_n, init_rpy_n = jax_init_normals(0, b, n)
    tick = jax.jit(partial(fleet_full_tick, cfg, mb, spec, ri, params,
                           mcl_cfg=mcl_cfg))
    args = dict(submap_ctx=submap, feature_map_pts=jnp.asarray(w.walls),
                feature_ground_pts=jnp.asarray(w.ground))
    rec = {k: [] for k in DRAW_KEYS}
    outs = {k: [] for k in ("pos", "quat", "v", "w", "decision",
                            "cmd_source", "ps_simple", "ps_rotate",
                            "plan_ok", "wf_iters", "vx", "wz", "plan_pos",
                            "plan_yaw", "mcl_err")}
    for t in range(entry.CONFIG4_TICKS + 1):
        for k, v in jax_mcl_draws(state.mcl.key, n).items():
            rec[k].append(v)
        for k in ("pos", "quat", "v", "w"):
            outs[k].append(np.asarray(getattr(state, k)))
        for k, v in mcl_fields(state.mcl).items():
            outs.setdefault(k, []).append(v)
        drift, drift_yaw, now = entry.config4_drift(t)
        state, diag = tick(fmap, state, w.scans, w.masks,
                           jnp.asarray(entry.CONFIG4_OFFSET), w.goals,
                           jnp.float32(now), jnp.float32(entry.CONFIG4_DT),
                           odom_drift_pos=jnp.asarray(drift),
                           odom_drift_yaw=jnp.asarray(drift_yaw), **args)
        for k in diag:
            if k in outs and len(outs[k]) == t:
                outs[k].append(np.asarray(diag[k]))
        print(f"tick {t}: {time.time() - t0:.1f} s; decisions "
              f"{np.bincount(outs['decision'][-1], minlength=10).tolist()}; "
              f"iters {int(outs['wf_iters'][-1][0])}; mcl_err max "
              f"{float(outs['mcl_err'][-1].max()):.3f}", flush=True)
    data = {k: np.stack(v) for k, v in {**rec, **outs}.items()}
    np.savez_compressed(OUT, init_pos_n=init_pos_n, init_rpy_n=init_rpy_n,
                        **data)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB) in "
          f"{time.time() - t0:.0f} s")


if __name__ == "__main__":
    main()
