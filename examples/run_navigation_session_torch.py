"""Full-vertical navigation demo on the PyTorch port: the reference's
headline scenario (`dummy_pc_pub` toggling wall + full stack) driven from
simulated lidar scans and two depth cameras — perception mark/clear, the
zone layers, stacked dGraph composition, DWA global replans, the sampling
local planner, the move-base FSM — through ``entry.make_session``.

The PyTorch counterpart of ``examples/run_navigation_session.py``. Runs on
the card by default; ``--device cpu`` runs it on the CPU.

Usage: python examples/run_navigation_session_torch.py [--ticks 600]
       [--wall-period 15] [--device cuda]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=600)
    ap.add_argument("--wall-period", type=float, default=15.0,
                    help="toggling-wall period (s), like dummy_pc_pub")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from dddmr_navigation_tpu_torch import entry
    from dddmr_navigation_tpu_torch.control.fsm import Decision
    from dddmr_navigation_tpu_torch.utils.lidar_sim import BoxWorld

    walled = entry.session_scenario()
    room = walled._replace(world=BoxWorld.room(half=6.0, wall_h=1.5))
    sess = entry.make_session(walled, device=args.device)
    sess.set_goal(walled.goal)
    pos, yaw, v, w = walled.start.copy(), 0.0, 0.0, 0.0
    last_dec = None
    t_start = time.perf_counter()
    for i in range(args.ticks):
        now = i * entry.SESSION_DT
        up = (now % args.wall_period) < args.wall_period / 2
        sc = walled if up else room
        pts, mask, quat, frames = entry.session_inputs(sc, pos, yaw)
        for c, (cp, cq, dp) in enumerate(frames):
            sess.push_depth_observation(c, cp, cq, dp, now)
        vx, wz, dec, done, ok = sess.tick(pts, mask, pos, quat, v, w, now)
        v, w = vx, wz
        pos, yaw = entry.step_pose(pos, yaw, v, w)
        if dec != last_dec:
            print(f"t={now:5.1f}s  {Decision(dec).name:22s} "
                  f"pos=({pos[0]:+.2f},{pos[1]:+.2f}) "
                  f"wall={'UP' if up else 'down'}")
            last_dec = dec
        if done:
            wall_s = time.perf_counter() - t_start
            print(f"{'SUCCESS' if ok else 'ABORT'} at t={now:.1f}s "
                  f"pos=({pos[0]:+.2f},{pos[1]:+.2f}) "
                  f"[{wall_s:.1f}s wall, {1e3*wall_s/(i+1):.0f} ms/tick]")
            return 0 if ok else 1
    print(f"ran out of ticks at pos=({pos[0]:+.2f},{pos[1]:+.2f})")
    return 1


if __name__ == "__main__":
    sys.exit(main())
