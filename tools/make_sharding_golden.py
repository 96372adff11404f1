"""Write the JAX package's sharded fleet ticks over its 8-device CPU mesh
as a golden file for the PyTorch port's sharded ticks.

Runs, with ``jax_num_cpu_devices = 8`` (as ``tests/conftest.py`` sets it),
``dddmr_navigation_tpu.parallel.fleet``'s ``sharded_fleet_tick`` on
``tests/test_multihost.py``'s tiny local tick (16 robots),
``sharded_fused_fleet_tick`` on ``test_sharded_fused_vertical_fleet_8_devices``'s
world (8 robots, the LOS gate at ``dryrun_multichip``'s sizes) and ``sharded_fleet_full_tick`` on
``__graft_entry__.dryrun_multichip``'s config and world at 16 robots, two
chained ticks. The inputs come from this file's builders, which take
either package's config and map modules, so the golden file and the port
start from the same arrays.

Saves to ``dddmr_navigation_tpu_torch/testdata/sharding_golden.npz``:

* ``init_pos_n``, ``init_rpy_n`` (16, 20, 3): the MCL's initial unit
  normals; per tick k, ``full{k}_<draw>`` the unit draws each filter
  consumed (``interop.DRAW_KEYS``), ``full{k}_<diag>`` the outputs
  ``decision``, ``cmd_source``, ``ps_simple``, ``ps_rotate``, ``plan_ok``,
  ``wf_iters``, ``vx``, ``wz``, ``plan_pos``, ``plan_yaw``, ``mcl_err``,
  and ``full{k}_found``, the psum'd count of robots at TRAJECTORY_FOUND;
* ``fused_vx``, ``fused_wz``, ``fused_codes``, ``fused_ok`` and
  ``fused_found`` (the psum);
* ``local_vx``, ``local_wz``, ``local_codes``, ``local_costs`` and
  ``local_mean`` (the psum'd mean cost).

``tests/test_torch_sharding.py`` holds the port to it. ~2 minutes on a
2-core CPU:

    JAX_PLATFORMS=cpu python tools/make_sharding_golden.py
"""
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                   "sharding_golden.npz")
FULL_B, FUSED_B, LOCAL_B = 16, 8, 16
FULL_TICKS = 2
FULL_DIAG = ("decision", "cmd_source", "ps_simple", "ps_rotate", "plan_ok",
             "wf_iters", "vx", "wz", "plan_pos", "plan_yaw", "mcl_err")



def local_setup(C, b=LOCAL_B):
    """``tests/test_multihost.py::_tiny_setup``: the config and the numpy
    inputs (a straight 3 m plan, robots at the origin, obstacles 50 m
    away)."""
    cfg = C.LocalPlannerConfig(
        max_plan_len=64, max_prune_len=32, max_obstacle_points=64,
        generator=C.DDSimpleGeneratorConfig(
            linear_x_sample=3, angular_z_sample=3, max_num_steps=16,
            sim_granularity=0.2, angular_sim_granularity=0.1))
    xs = np.arange(0, 3.0, 0.1, dtype=np.float32)
    plan = np.stack([xs, np.zeros_like(xs), np.zeros_like(xs)], 1)
    return cfg, dict(plan=np.broadcast_to(plan, (b,) + plan.shape).copy(),
                     obstacles=np.full((b, 64, 3), 50.0, np.float32),
                     obs_valid=np.ones((b, 64), bool))


def fused_setup(C, M, b=FUSED_B):
    """``test_sharded_fused_vertical_fleet_8_devices``'s config and world
    (8 robots in a column, each with a post 0.6 m ahead in its own scan),
    with ``dryrun_multichip``'s LOS sizes (32 long edges, 4 samples, 128
    lethal points): the default 4,096 long edges × 32 samples × 2,048
    lethal points cost the port's LOS gate 40 s a tick on a 2-core CPU."""
    lidar = C.SpinningLidarConfig(
        scan_effective_positive_start=0.0, scan_effective_negative_start=0.0,
        max_scan_points=512)
    cfg = C.NavigationConfig(
        perception=C.PerceptionConfig(lidar=lidar, voxel_window_cells_xy=32,
                                      voxel_window_cells_z=24,
                                      max_marked_voxels=128),
        local_planner=C.LocalPlannerConfig(
            generator=C.DDSimpleGeneratorConfig(
                linear_x_sample=3, angular_z_sample=4, max_num_steps=12),
            max_obstacle_points=128, collision_obstacle_chunk=16,
            collision_near_k=32),
        global_planner=C.GlobalPlannerConfig(
            max_long_edges=32, los_samples=4, max_lethal_points=128))
    ground = M.flat_ground_map(8, 5, 0.25)
    n_pad = 512
    scans = np.zeros((b, n_pad, 3), np.float32)
    masks = np.zeros((b, n_pad), bool)
    for i in range(b):
        box = M.box_obstacle([-3.0 + 0.6, 0.3 * (i - 4) + 0.55, 0.0],
                             size=(0.2, 0.2, 1.0), resolution=0.1)
        rel = box - np.array([-3.0, 0.3 * (i - 4), 0.3], np.float32)
        scans[i, :len(rel)] = rel[:n_pad]
        masks[i, :min(len(rel), n_pad)] = True
    positions = np.stack([np.full(b, -3.0), 0.3 * (np.arange(b) - 4),
                          np.zeros(b)], 1).astype(np.float32)
    goals = np.stack([np.full(b, 3.0), 0.3 * (np.arange(b) - 4),
                      np.zeros(b)], 1).astype(np.float32)
    return cfg, dict(ground=ground, scans=scans, masks=masks,
                     positions=positions,
                     quats=np.tile(np.float32([[0, 0, 0, 1]]), (b, 1)),
                     goals=goals, v=np.full((b,), 0.2, np.float32),
                     w=np.zeros((b,), np.float32),
                     offset=np.float32([0.0, 0.0, 0.3]))


def full_setup(C, M, b=FULL_B):
    """``dryrun_multichip``'s config and world (its MCL with 20 particles
    in ``nearest`` mode), at 16 robots."""
    lidar = C.SpinningLidarConfig(
        scan_effective_positive_start=0.0, scan_effective_negative_start=0.0,
        max_scan_points=256)
    cfg = C.NavigationConfig(
        perception=C.PerceptionConfig(lidar=lidar, voxel_window_cells_xy=32,
                                      voxel_window_cells_z=12,
                                      max_marked_voxels=128),
        local_planner=C.LocalPlannerConfig(
            generator=C.DDSimpleGeneratorConfig(
                linear_x_sample=5, angular_z_sample=5, max_num_steps=16),
            max_obstacle_points=128, collision_obstacle_chunk=16,
            collision_near_k=32),
        global_planner=C.GlobalPlannerConfig(
            turning_weight=0.1, max_long_edges=32, los_samples=4,
            max_lethal_points=128, max_relax_iters=64, max_path_len=128))
    mcl = C.MCLConfig(num_particles=20, init_var_x=0.3, init_var_y=0.3,
                      init_var_z=0.1, init_var_yaw=0.1,
                      field_sampling="nearest")
    ground = M.flat_ground_map(6, 5, 0.5)
    walls = np.concatenate([
        M.box_obstacle([-2.6, 0.0, 0.0], size=(0.3, 4.4, 1.0),
                       resolution=0.2),
        M.box_obstacle([2.6, 0.0, 0.0], size=(0.3, 4.4, 1.0),
                       resolution=0.2),
        M.box_obstacle([0.0, -2.1, 0.0], size=(5.0, 0.3, 1.0),
                       resolution=0.2),
    ]).astype(np.float32)
    positions = np.stack([np.full(b, -1.8), 3.0 * (np.arange(b) / b - 0.5),
                          np.zeros(b)], 1).astype(np.float32)
    n_pad = 256
    scans = np.zeros((b, n_pad, 3), np.float32)
    masks = np.zeros((b, n_pad), bool)
    for i in range(b):
        box = M.box_obstacle([positions[i, 0] + 1.0, positions[i, 1] + 0.5,
                              0.0], size=(0.2, 0.2, 0.6), resolution=0.1)
        rel = (box - (positions[i] + [0, 0, 0.3]))[:n_pad]
        scans[i, :len(rel)] = rel
        masks[i, :len(rel)] = True
    drift = (np.full((b, 3), 0.02, np.float32)
             * np.float32([0.7, 0.7, 0.0])).astype(np.float32)
    return (cfg, C.MoveBaseConfig(), mcl), dict(
        ground=ground, walls=walls, positions=positions,
        quats=np.tile(np.float32([[0, 0, 0, 1]]), (b, 1)),
        goals=positions + np.array([3.4, 0.2, 0.0], np.float32),
        scans=scans, masks=masks, drift=drift,
        drift_yaw=np.zeros((b,), np.float32),
        offset=np.float32([0.0, 0.0, 0.3]))


# ---------------------------------------------------------------------------
# the JAX package's sharded ticks over its 8-device CPU mesh
# ---------------------------------------------------------------------------

def jax_local():
    """(vx, wz, codes, costs, mean cost) of the sharded local tick."""
    import jax
    import jax.numpy as jnp
    from dddmr_navigation_tpu import config as C
    from dddmr_navigation_tpu.parallel import (
        FleetState, make_fleet_mesh, sharded_fleet_tick)
    from dddmr_navigation_tpu.parallel.fleet import shard_fleet_arrays
    from dddmr_navigation_tpu.planning.local.planner import make_global_plan
    cfg, x = local_setup(C)
    b = x["plan"].shape[0]
    plan1 = make_global_plan(x["plan"][0], max_len=cfg.max_plan_len)
    plans = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a[None], (b,) + a.shape), plan1)
    state = FleetState(pos=jnp.zeros((b, 3)),
                       quat=jnp.tile(jnp.float32([[0, 0, 0, 1]]), (b, 1)),
                       v=jnp.zeros((b,)), w=jnp.zeros((b,)))
    mesh = make_fleet_mesh(8)
    out = sharded_fleet_tick(cfg, mesh)(*shard_fleet_arrays(
        mesh, (plans, state, jnp.asarray(x["obstacles"]),
               jnp.asarray(x["obs_valid"]))))
    return [np.asarray(v) for v in out]


def jax_fused():
    """(vx, wz, codes, plan_ok, found) of the sharded fused tick."""
    import jax
    import jax.numpy as jnp
    from dddmr_navigation_tpu import config as C
    from dddmr_navigation_tpu.control.fused import (
        build_fused_map, init_fused_state, make_fused_tick)
    from dddmr_navigation_tpu.io import maps as M
    from dddmr_navigation_tpu.parallel.fleet import (
        make_fleet_mesh, shard_fleet_arrays, sharded_fused_fleet_tick)
    cfg, x = fused_setup(C, M)
    fmap = build_fused_map(cfg, x["ground"])
    _, spec, ri, params = make_fused_tick(cfg)
    states = jax.tree_util.tree_map(
        lambda *a: jnp.stack(a),
        *[init_fused_state(cfg, len(x["ground"]),
                           robot_xyz=x["positions"][i])
          for i in range(FUSED_B)])
    mesh = make_fleet_mesh(8)
    per = shard_fleet_arrays(mesh, (
        states, jnp.asarray(x["scans"]), jnp.asarray(x["masks"]),
        jnp.asarray(x["positions"]), jnp.asarray(x["quats"]),
        jnp.asarray(x["goals"]), jnp.asarray(x["v"]), jnp.asarray(x["w"])))
    _, vx, wz, codes, ok, found = sharded_fused_fleet_tick(
        cfg, spec, ri, params, mesh)(fmap, *per[:5],
                                     jnp.asarray(x["offset"]), *per[5:])
    return [np.asarray(v) for v in (vx, wz, codes, ok, found)]


def jax_full():
    """The sharded full tick chained FULL_TICKS times: (the initial
    normals, per tick a dict of the draws its filters consumed (replayed
    from their keys), its diag and its psum'd found count)."""
    import jax.numpy as jnp
    from dddmr_navigation_tpu import config as C
    from dddmr_navigation_tpu.control.fused import (
        build_fused_map, make_fused_tick)
    from dddmr_navigation_tpu.io import maps as M
    from dddmr_navigation_tpu.parallel.fleet import (
        init_fleet_full_state, make_fleet_mesh, shard_fleet_arrays,
        sharded_fleet_full_tick)
    from dddmr_navigation_tpu.state_estimation.likelihood import (
        build_submap_context)
    from tools.make_config4_golden import jax_init_normals, jax_mcl_draws
    (cfg, mb, mcl), x = full_setup(C, M)
    fmap = build_fused_map(cfg, x["ground"], x["walls"])
    submap = build_submap_context(x["walls"], x["ground"], mcl)
    _, spec, ri, params = make_fused_tick(cfg)
    state = init_fleet_full_state(cfg, len(x["ground"]), x["positions"],
                                  x["quats"], localize=True, mcl_cfg=mcl)
    mesh = make_fleet_mesh(8)
    tick = sharded_fleet_full_tick(cfg, mb, spec, ri, params, mesh,
                                   mcl_cfg=mcl, localize=True)
    state, scans, masks, goals, drift, dyaw = shard_fleet_arrays(mesh, (
        state, jnp.asarray(x["scans"]), jnp.asarray(x["masks"]),
        jnp.asarray(x["goals"]), jnp.asarray(x["drift"]),
        jnp.asarray(x["drift_yaw"])))
    ticks = []
    for k in range(FULL_TICKS):
        rec = {f"draw_{n}": v for n, v in jax_mcl_draws(
            np.asarray(state.mcl.key), mcl.num_particles).items()}
        state, diag, found = tick(
            fmap, submap, jnp.asarray(x["walls"]), jnp.asarray(x["ground"]),
            state, scans, masks, jnp.asarray(x["offset"]), goals,
            jnp.float32(0.1 * k), jnp.float32(0.1), drift, dyaw)
        rec.update({name: np.asarray(diag[name]) for name in FULL_DIAG})
        rec["found"] = np.asarray(found)
        ticks.append(rec)
    return jax_init_normals(0, FULL_B, mcl.num_particles), ticks


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    t0 = time.time()
    (pos_n, rpy_n), ticks = jax_full()
    out = dict(init_pos_n=pos_n, init_rpy_n=rpy_n)
    for k, rec in enumerate(ticks):
        out.update({f"full{k}_{n}": v for n, v in rec.items()})
    print(f"full tick: {time.time() - t0:.0f} s", flush=True)
    for n, v in zip(("vx", "wz", "codes", "ok", "found"), jax_fused()):
        out[f"fused_{n}"] = v
    print(f"fused tick: {time.time() - t0:.0f} s", flush=True)
    for n, v in zip(("vx", "wz", "codes", "costs", "mean"), jax_local()):
        out[f"local_{n}"] = v
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e3:.0f} kB) in "
          f"{time.time() - t0:.0f} s")


if __name__ == "__main__":
    main()
