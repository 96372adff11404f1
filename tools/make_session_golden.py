"""Write the JAX package's navigation-session chain as a golden file for
the PyTorch port.

Runs ``dddmr_navigation_tpu.control.session.NavigationSession`` closed loop
through the session scenario of ``dddmr_navigation_tpu_torch.entry``
(``session_scenario()``: the session demo's world, route and full-width
``NavigationConfig()``, with two depth cameras, a no-entry zone and a slow
zone) on the CPU, until it is done or ``entry.SESSION_TICKS`` ticks. The
scenario, the scans and the camera frames come from the port's own
functions, so the golden file and the port start from the same arrays.

Saves, compressed, to
``dddmr_navigation_tpu_torch/testdata/session_golden.npz``:

* for every tick, its outputs: ``vx``, ``wz``, ``decision``, ``done``,
  ``succeeded``, ``planner_state`` (the move base's last simple-generator
  state, -1 when the tick did not run it), ``plan_count`` (poses of the
  adopted plan, 0 for none), ``pivot`` (the DWA recompute's pivot, -1
  when none ran), the pose it started from (``pos``, ``yaw``);
* for the first ``REPLAY_TICKS`` ticks (``replay_ticks``; all of them
  at the default), under ``tick_`` + the name, its inputs:
  the scan's valid points and their ray indices (``scan_pts``,
  ``scan_idx``, with ``scan_n`` rays in all), the robot's ``quat``, ``v``,
  ``w``, ``now``, each camera's frame (``cam_pos``, ``cam_quat``,
  ``depth_pts``); the composed distance field after the tick (sparse:
  ``composed_idx``, ``composed_val``); and the state the tick started
  from, ``state_`` + ``interop.session_fields``'s names (ragged keys with
  ``__len``; ``interop.tick_of(record, t, "tick_")`` reads tick t).

``chip_smoke.py`` and ``tests/test_torch_session.py`` hold the port to it.
~10 minutes on a 2-core CPU:

    JAX_PLATFORMS=cpu python tools/make_session_golden.py
"""
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                   "session_golden.npz")
REPLAY_TICKS = 600


def jax_config(obj):
    """The JAX package's config dataclass of the same class name as
    ``obj`` (one of the port's), field by field."""
    from dddmr_navigation_tpu.config import schema
    cls = getattr(schema, type(obj).__name__)
    out = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            v = jax_config(v)
        out[f.name] = v
    return cls(**out)


def jax_session(sc, threaded: bool = False):
    """The JAX package's session for a port ``SessionScenario``, its DWA
    pivot recorded in ``sess.driver.plan_manager.dwa.last_pivot``."""
    from dddmr_navigation_tpu.control.session import NavigationSession
    from dddmr_navigation_tpu.perception.depth_camera import CameraModel
    from dddmr_navigation_tpu_torch import entry

    sess = NavigationSession(
        jax_config(sc.cfg), sc.ground, no_entry_zones=sc.no_entry,
        speed_zones=sc.speed_zone, sensor_offset=entry.SESSION_OFFSET,
        threaded_plan_manager=threaded, depth_cameras=sc.cameras,
        depth_camera_model=CameraModel(*sc.camera),
        depth_buffer_depth=sc.buffer_depth, depth_max_points=sc.depth_points)
    dwa = sess.driver.plan_manager.dwa
    dwa.last_pivot = -1
    pivot_fn = dwa._jit_pivot

    def recording(*a, **k):
        pivot, i0 = pivot_fn(*a, **k)
        dwa.last_pivot = int(pivot)
        return pivot, i0
    dwa._jit_pivot = recording
    return sess


def record_chain(sess, sc, ticks: int, replay_ticks: int, log=None):
    """Run the scenario closed loop on ``sess`` (the JAX package's or the
    port's) and return the golden record (a dict of numpy arrays)."""
    import numpy as np
    from dddmr_navigation_tpu_torch import entry
    from dddmr_navigation_tpu_torch.interop import (
        pack_ticks, session_fields, to_numpy)

    fill = np.float32(sc.cfg.perception.max_obstacle_distance)
    rows, outs = [], []
    v_w = [0.0, 0.0]

    def inputs(t, pos, yaw):
        pts, mask, quat, frames = entry.session_inputs(sc, pos, yaw)
        sess.driver.last_planner_state = -1
        sess.driver.plan_manager.dwa.last_pivot = -1
        if t < replay_ticks:
            idx = np.flatnonzero(mask).astype(np.int32)
            row = {"scan_pts": pts[idx], "scan_idx": idx,
                   "scan_n": np.asarray(len(mask)), "quat": quat,
                   "v": np.asarray(v_w[0], np.float32),
                   "w": np.asarray(v_w[1], np.float32),
                   "now": np.asarray(t * entry.SESSION_DT, np.float64)}
            for c, (cp, cq, dp) in enumerate(frames):
                row[f"cam_pos{c}"], row[f"cam_quat{c}"] = cp, cq
                row[f"depth_pts{c}"] = dp
            row.update({f"state_{k}": v
                        for k, v in session_fields(sess).items()})
            rows.append(row)
        return pts, mask, quat, frames

    def on_tick(t, out):
        vx, wz, dec, done, ok = out
        v_w[:] = [vx, wz]
        outs.append({"vx": np.float32(vx), "wz": np.float32(wz),
                     "decision": int(dec), "done": bool(done),
                     "succeeded": bool(ok),
                     "planner_state": int(
                         -1 if sess.driver.last_planner_state is None
                         else sess.driver.last_planner_state),
                     "pivot": int(sess.driver.plan_manager.dwa.last_pivot)})
        if t < replay_ticks:
            dg = np.asarray(to_numpy(sess.composed_dgraph)).reshape(-1)
            idx = np.flatnonzero(dg != fill).astype(np.int32)
            rows[t]["composed_idx"], rows[t]["composed_val"] = idx, dg[idx]
        if log is not None:
            log(t, out)

    chain = entry.run_session_chain(sess, sc, ticks, inputs=inputs,
                                    on_tick=on_tick)
    data = {k: np.asarray([o[k] for o in outs]) for k in outs[0]}
    data.update(pos=chain.pos, yaw=chain.yaw, plan_count=chain.plan_count)
    data.update(pack_ticks(rows, "tick_"))
    data["replay_ticks"] = np.asarray(len(rows))
    return data


def main():
    import numpy as np
    from dddmr_navigation_tpu_torch import entry

    t0 = time.time()
    sc = entry.session_scenario()
    sess = jax_session(sc)

    def log(t, out):
        if t % 10 == 0 or out[3]:
            print(f"tick {t}: {time.time() - t0:.1f} s; decision "
                  f"{int(out[2])}; cmd ({out[0]:.3f}, {out[1]:.3f}); done "
                  f"{out[3]} ok {out[4]}; planner state "
                  f"{sess.driver.last_planner_state}", flush=True)
    data = record_chain(sess, sc, entry.SESSION_TICKS, REPLAY_TICKS, log)
    np.savez_compressed(OUT, **data)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB), "
          f"{len(data['vx'])} ticks, in {time.time() - t0:.0f} s")


if __name__ == "__main__":
    main()
