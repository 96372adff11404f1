"""Write the JAX package's headline fleet tick 0, and the state codes of
its 50-tick chain, as a golden file for the PyTorch port.

Runs ``compute_velocity_command`` of ``dddmr_navigation_tpu`` over the
64-robot fleet of ``bench.py::bench_headline`` (16×16 window, 289 padded
samples, 40 steps, 512 obstacles per robot, near-K 128, the same seeds,
plans and start poses) on the CPU, and saves tick 0's ``vx``, ``wz``,
``state``, ``best_index`` and ``costs`` (B×289), and the state codes of
the headline's 50-tick chain (``chain_state``, 50×B, ticks chained through
``integrate_fleet``), to
``dddmr_navigation_tpu_torch/testdata/headline_tick0.npz``.
``chip_smoke.py`` and ``tests/test_torch_planner.py`` hold the port to it.
The configuration and the numpy inputs come from the port's own builders
(``dddmr_navigation_tpu_torch.entry.headline_config`` and
``headline_numpy``), so the golden file and the port start from the same
arrays.

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                   "headline_tick0.npz")


def main(robots=64, ticks=50):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from dddmr_navigation_tpu.geometry import quat_from_yaw
    from dddmr_navigation_tpu.planning.local.planner import (
        make_global_plan, compute_velocity_command)
    from dddmr_navigation_tpu.parallel.fleet import (
        FleetState, fleet_tick, integrate_fleet)
    from dddmr_navigation_tpu_torch.entry import (
        headline_config, headline_numpy)

    jax.config.update("jax_platforms", "cpu")
    # bench.py:128-172, tick 0 of the chain; the JAX package's default
    # collision backend ("xla").
    cfg = headline_config()
    b = robots
    plans_np, obstacles, obs_valid, pos = headline_numpy(
        b, cfg.max_obstacle_points)
    plans = jax.tree_util.tree_map(
        lambda *x: jnp.stack(x),
        *[make_global_plan(p, max_len=cfg.max_plan_len) for p in plans_np])
    obstacles, obs_valid, pos = map(jnp.asarray, (obstacles, obs_valid, pos))
    quat = jnp.broadcast_to(quat_from_yaw(jnp.float32(0.0)), (b, 4))
    zeros = jnp.zeros((b,))

    def one(plan, p, q, v, w, obs, om):
        cmd = compute_velocity_command(cfg, plan, p, q, v, w, obs, om)
        return cmd.vx, cmd.wz, cmd.state, cmd.best_index, cmd.costs

    vx, wz, state, best, costs = jax.jit(jax.vmap(one))(
        plans, pos, quat, zeros, zeros, obstacles, obs_valid)

    @jax.jit
    def chain(s0):
        def body(s, _):
            cvx, cwz, codes, _ = fleet_tick(cfg, plans, s, obstacles,
                                            obs_valid)
            return integrate_fleet(s, cvx, cwz,
                                   1.0 / cfg.controller_frequency), codes
        return jax.lax.scan(body, s0, None, length=ticks)[1]

    chain_state = chain(FleetState(pos=pos, quat=quat, v=zeros, w=zeros))
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez(OUT, vx=np.asarray(vx), wz=np.asarray(wz),
             state=np.asarray(state), best_index=np.asarray(best),
             costs=np.asarray(costs), chain_state=np.asarray(chain_state))
    print(f"wrote {OUT}: found at tick 0 {int(np.sum(np.asarray(state) == 4))}"
          f"/{b}, per tick {np.sum(np.asarray(chain_state) == 4, 1).tolist()}")


if __name__ == "__main__":
    main()
