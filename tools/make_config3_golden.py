"""Write the JAX package's fused config-3 chain as a golden file for the
PyTorch port.

Runs ``dddmr_navigation_tpu.control.fused.fused_tick`` at
``bench.py::bench_config3``'s full width (the multi-level map, 3,116
ground nodes; a 96×96×44 window; a 16×1000 lidar; 64×128 samples of 40
steps; near-K 128; 320 relaxation iterations; 16 direction bins) on the
CPU, for a 20-tick closed-loop chain: the robot starts at the bench's pose
with v = 0.3 m/s, each tick's scan is simulated with ``lidar_sim`` at the
robot's pose, and the robot then moves by its own command (perfect
execution, ``integrate_fleet``). Saves, compressed, to
``dddmr_navigation_tpu_torch/testdata/config3_golden.npz``:

* per tick (T = 20): the pose (``positions``, ``quats``, the scan's
  ``yaws``), the velocity the tick started from (``v_in``, ``w_in``), the
  scan's valid points and their ray indices (``scan_pts``, ``scan_idx``,
  ``scan_count``), ``state``, ``vx``, ``wz``, ``best_index``,
  ``best_cost``, ``costs`` (T × 8,192), ``plan_ok``, ``plan_count``,
  ``plan_positions``, ``wf_iters``; ``composed_first`` / ``composed_last``
  (the composed dGraph at ticks 0 and 19);
* tick 0's planner tables: ``enter``, ``goal_idx``, ``start_idx``,
  ``relaxed`` (the (G, 16) field), ``node_ids`` / ``node_valid`` of the
  extracted path, and the map's ``az``, ``bins`` and ``turn_pen``.

The configuration, map, world and scans come from the port's own functions
(``dddmr_navigation_tpu_torch.entry.config3_*``), so the golden file and
the port start from the same arrays. ``chip_smoke.py`` and
``tests/test_torch_fused.py`` hold the port to it.

    JAX_PLATFORMS=cpu python tools/make_config3_golden.py
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                   "config3_golden.npz")


def main(ticks=20):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from dddmr_navigation_tpu.geometry import quat_from_yaw, yaw_from_quat
    from dddmr_navigation_tpu.control.fused import (
        build_fused_map, init_fused_state, make_fused_tick, fused_pre_plan)
    from dddmr_navigation_tpu.planning.global_.wavefront import (
        wavefront_distances_turning)
    from dddmr_navigation_tpu.planning.global_.planner import plan_finish
    from dddmr_navigation_tpu.planning.local.planner import (
        compute_velocity_command)
    from dddmr_navigation_tpu.parallel.fleet import (
        FleetState, integrate_fleet)
    from dddmr_navigation_tpu_torch import entry

    jax.config.update("jax_platforms", "cpu")
    cfg = entry.config3_config()
    gp = cfg.global_planner
    ground, map_pts, weights, static_dgraph = entry.config3_map()
    fmap = build_fused_map(cfg, ground, map_pts, node_weight=weights,
                           static_dgraph=static_dgraph)
    tick, spec, ri_spec, params = make_fused_tick(cfg)
    world = entry.config3_world()
    offset = jnp.asarray(entry.CONFIG3_OFFSET, jnp.float32)
    goal = jnp.asarray(entry.CONFIG3_GOAL, jnp.float32)
    robot = np.asarray(entry.CONFIG3_ROBOT, np.float32)
    state = init_fused_state(cfg, len(ground), robot_xyz=robot)

    @jax.jit
    def command(plan, pos, quat, v, w, obs, obs_mask):
        cmd = compute_velocity_command(cfg.local_planner, plan, pos, quat,
                                       v, w, obs, obs_mask,
                                       allowed_max_speed=-1.0)
        return cmd.best_index, cmd.costs

    @jax.jit
    def tick0_tables(fmap, state, scan, smask, pos, quat, v, w):
        pre = fused_pre_plan(cfg, spec, ri_spec, params, fmap, state, scan,
                             smask, pos, quat, offset, goal)
        dist, _, iters = wavefront_distances_turning(
            fmap.nbr_idx, fmap.nbr_dist, pre.prep.graph_valid,
            pre.prep.enter, fmap.avg_intensity, pre.prep.goal_idx,
            fmap.ground, gp.turning_weight, n_dir_bins=gp.turning_dir_bins,
            max_iters=gp.max_relax_iters, dist0=pre.prep.warm_dist,
            az=fmap.wf_az, bin_of_edge=fmap.wf_bins)
        res = plan_finish(gp, fmap.nbr_idx, fmap.nbr_dist, fmap.ground,
                          pre.prep, dist, iters, turn_pen=fmap.turn_pen,
                          wf_bins=fmap.wf_bins)
        return (pre.prep.enter, pre.prep.goal_idx, pre.prep.start_idx, dist,
                res.node_ids, res.node_valid)

    pos = jnp.asarray(robot)
    quat = quat_from_yaw(jnp.float32(0.0))
    v, w = jnp.float32(entry.CONFIG3_V0), jnp.float32(0.0)
    rec = {k: [] for k in (
        "positions", "quats", "yaws", "v_in", "w_in", "state", "vx", "wz",
        "best_index", "best_cost", "costs", "plan_ok", "plan_count",
        "plan_positions", "wf_iters")}
    scan_pts, scan_idx, scan_count = [], [], []
    tables = None
    for t in range(ticks):
        t0 = time.time()
        yaw = np.float32(yaw_from_quat(quat))
        pts, mask = entry.config3_scan(cfg, world, np.asarray(pos), float(yaw))
        if t == 0:
            tables = tick0_tables(fmap, state, pts, mask, pos, quat, v, w)
        state, out = tick(fmap, state, pts, mask, pos, quat, offset, goal,
                          v, w)
        best, costs = command(out.plan, pos, quat, v, w, out.obs,
                              out.obs_mask)
        for k, x in (("positions", pos), ("quats", quat), ("yaws", yaw),
                     ("v_in", v), ("w_in", w), ("state", out.state),
                     ("vx", out.vx), ("wz", out.wz), ("best_index", best),
                     ("best_cost", out.best_cost), ("costs", costs),
                     ("plan_ok", out.plan_ok), ("plan_count", out.plan.count),
                     ("plan_positions", out.plan.positions),
                     ("wf_iters", out.wf_iters)):
            rec[k].append(np.asarray(x))
        idx = np.flatnonzero(mask)
        scan_idx.append(idx.astype(np.int16))
        scan_pts.append(pts[idx])
        scan_count.append(len(idx))
        if t == 0:
            composed_first = np.asarray(out.composed_dgraph)
        composed_last = np.asarray(out.composed_dgraph)
        nxt = integrate_fleet(
            FleetState(pos=pos[None], quat=quat[None], v=v[None], w=w[None]),
            out.vx[None], out.wz[None], 1.0 / cfg.local_planner.controller_frequency)
        pos, quat, v, w = nxt.pos[0], nxt.quat[0], out.vx, out.wz
        print(f"tick {t}: state {int(out.state)} plan_ok {bool(out.plan_ok)} "
              f"count {int(out.plan.count)} iters {int(out.wf_iters)} "
              f"vx {float(out.vx):.3f} wz {float(out.wz):.3f} best "
              f"{int(best)} ({time.time() - t0:.1f} s)", flush=True)

    enter, goal_idx, start_idx, relaxed, node_ids, node_valid = tables
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(
        OUT, **{k: np.stack(x) for k, x in rec.items()},
        scan_pts=np.concatenate(scan_pts), scan_idx=np.concatenate(scan_idx),
        scan_count=np.asarray(scan_count),
        composed_first=composed_first, composed_last=composed_last,
        enter=np.asarray(enter), goal_idx=np.asarray(goal_idx),
        start_idx=np.asarray(start_idx), relaxed=np.asarray(relaxed),
        node_ids=np.asarray(node_ids), node_valid=np.asarray(node_valid),
        az=np.asarray(fmap.wf_az), bins=np.asarray(fmap.wf_bins).astype(np.int8),
        turn_pen=np.asarray(fmap.turn_pen))
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
