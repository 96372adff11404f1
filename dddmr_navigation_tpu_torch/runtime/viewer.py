"""Live operator surface: a dependency-free web viewer + command channel.

The reference ships rviz tools for this role — 3D goal / initial-pose
tools that raycast onto the point-cloud map and Qt panels
(`src/dddmr_rviz_tools/`, ~3.4k LoC of Qt/OGRE). The TPU-native stack
has no ROS graph to visualize, so the equivalent surface is a small HTTP
server over the session's state snapshots:

  * top-down map render with the dGraph distance field as heat,
  * live plan, best-rollout trace, robot pose, MCL particles,
  * click-to-set **goal** (left click) and **initial pose** (shift-click)
    — snapped onto the ground cloud exactly like the rviz 3D tools
    raycast onto the map cloud,
  * decision/PlannerState readout.

Thread model: the host control loop calls :meth:`publish` with plain
NumPy snapshots each tick (never device tensors — no device traffic on the
server thread), and polls :meth:`pop_goal` / :meth:`pop_initial_pose`
to apply operator commands inside the loop. The HTTP thread only ever
reads the latest snapshot reference (atomic swap) and appends clicks.

Zero external dependencies: stdlib ``http.server`` + a single inline
HTML/JS page; works over SSH port-forwarding.

The port's own copy of ``dddmr_navigation_tpu/runtime/viewer.py`` (the
standard library and numpy); ``tests/test_torch_runtime_io.py`` holds it
to the original.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>dddmr_navigation_tpu</title><style>
 body{margin:0;background:#111;color:#ddd;font:13px monospace}
 #hud{position:fixed;top:8px;left:8px;background:#000a;padding:6px 10px;
      border-radius:4px;white-space:pre}
 canvas{display:block}
</style></head><body>
<div id="hud">loading…</div><canvas id="c"></canvas>
<script>
const cv = document.getElementById('c'), hud = document.getElementById('hud');
const ctx = cv.getContext('2d');
let map = null, st = null, T = null;
let zlo = -1e9, zhi = 1e9;   // floor filter (keys 1/2/0)
function fit() {
  cv.width = innerWidth; cv.height = innerHeight;
  if (!map) return;
  const [x0,y0,x1,y1] = map.bounds, pad = 30;
  const sx = (cv.width-2*pad)/(x1-x0), sy = (cv.height-2*pad)/(y1-y0);
  const s = Math.min(sx, sy);
  T = {s, ox: pad - x0*s, oy: cv.height - pad + y0*s};
}
const W2C = p => [p[0]*T.s + T.ox, T.oy - p[1]*T.s];
const C2W = (px,py) => [(px - T.ox)/T.s, (T.oy - py)/T.s];
function heat(v, max) {       // dGraph distance → color (lethal=red)
  if (v >= max) return '#2a4a2a';
  const t = Math.min(v/3.0, 1.0);
  const r = Math.round(255*(1-t)), g = Math.round(180*t);
  return `rgb(${r},${g},60)`;
}
function draw() {
  if (!map || !T) return;
  ctx.fillStyle = '#111'; ctx.fillRect(0,0,cv.width,cv.height);
  const dg = st ? st.dgraph : null;
  for (let i = 0; i < map.ground.length; i++) {
    const z = map.z[i];
    if (z < zlo || z > zhi) continue;
    const p = W2C(map.ground[i]);
    ctx.fillStyle = dg ? heat(dg[i], 9000) : '#2a4a2a';
    ctx.fillRect(p[0]-1, p[1]-1, 2.4, 2.4);
  }
  if (!st) return;
  if (st.particles) {
    ctx.fillStyle = '#58f';
    for (const q of st.particles) {
      const p = W2C(q); ctx.fillRect(p[0]-1, p[1]-1, 2, 2); }
  }
  if (st.plan && st.plan.length > 1) {
    ctx.strokeStyle = '#4cf'; ctx.lineWidth = 2; ctx.beginPath();
    st.plan.forEach((q,i)=>{const p=W2C(q); i?ctx.lineTo(...p):ctx.moveTo(...p)});
    ctx.stroke();
  }
  if (st.best_rollout && st.best_rollout.length > 1) {
    ctx.strokeStyle = '#fd4'; ctx.lineWidth = 2; ctx.beginPath();
    st.best_rollout.forEach((q,i)=>{const p=W2C(q); i?ctx.lineTo(...p):ctx.moveTo(...p)});
    ctx.stroke();
  }
  if (st.goal) {
    const p = W2C(st.goal);
    ctx.strokeStyle = '#f4f'; ctx.lineWidth = 2;
    ctx.beginPath(); ctx.arc(p[0], p[1], 7, 0, 7); ctx.stroke();
  }
  if (st.robot) {
    const p = W2C(st.robot), a = -st.robot[3];
    ctx.save(); ctx.translate(p[0], p[1]); ctx.rotate(a);
    ctx.fillStyle = '#fff'; ctx.beginPath();
    ctx.moveTo(10,0); ctx.lineTo(-6,5); ctx.lineTo(-6,-5); ctx.fill();
    ctx.restore();
  }
  hud.textContent =
    `decision ${st.decision}  planner_state ${st.planner_state}\\n` +
    `robot (${st.robot[0].toFixed(2)}, ${st.robot[1].toFixed(2)}, ` +
    `${st.robot[2].toFixed(2)})  v=${st.v.toFixed(2)} w=${st.w.toFixed(2)}\\n`+
    `tick ${st.tick}  click: goal  shift-click: pose  keys 1/2/0: floor`;
}
cv.addEventListener('click', async e => {
  if (!T) return;
  const w = C2W(e.clientX, e.clientY);
  const ep = e.shiftKey ? '/initial_pose' : '/goal';
  await fetch(ep, {method:'POST', body: JSON.stringify({x:w[0], y:w[1]})});
});
addEventListener('resize', () => {fit(); draw();});
addEventListener('keydown', e => {   // stacked-floor filter
  if (e.key === '0') { zlo = -1e9; zhi = 1e9; }
  if (e.key === '1') { zlo = -1e9; zhi = map.z_mid; }
  if (e.key === '2') { zlo = map.z_mid; zhi = 1e9; }
  draw();
});
(async () => {
  map = await (await fetch('/map')).json(); fit();
  for (;;) {
    try { st = await (await fetch('/state')).json(); } catch (e) {}
    draw();
    await new Promise(r => setTimeout(r, 200));
  }
})();
</script></body></html>"""


class NavViewer:
    """Serve the operator page over a live session's snapshots."""

    def __init__(self, ground: np.ndarray, host: str = "127.0.0.1",
                 port: int = 8123, max_points: int = 12000):
        ground = np.asarray(ground, np.float32)
        if len(ground) > max_points:
            stride = int(np.ceil(len(ground) / max_points))
            self._idx = np.arange(0, len(ground), stride)
        else:
            self._idx = np.arange(len(ground))
        self.ground = ground
        g = ground[self._idx]
        self._map_json = json.dumps({
            "ground": np.round(g[:, :2], 3).tolist(),
            "z": np.round(g[:, 2], 2).tolist(),
            # stacked-floor split point for the viewer's 1/2 filter keys
            "z_mid": float((g[:, 2].min() + g[:, 2].max()) / 2.0),
            "bounds": [float(g[:, 0].min()), float(g[:, 1].min()),
                       float(g[:, 0].max()), float(g[:, 1].max())],
        }).encode()
        self._state_json = b"null"
        self._goal_clicks: list = []
        self._pose_clicks: list = []
        self._lock = threading.Lock()

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # silence request spam
                pass

            def _send(self, body, ctype="application/json"):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/":
                    self._send(_PAGE.encode(), "text/html")
                elif self.path == "/map":
                    self._send(viewer._map_json)
                elif self.path == "/state":
                    self._send(viewer._state_json)
                else:
                    self.send_error(404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    xy = (float(payload["x"]), float(payload["y"]))
                except (ValueError, KeyError):
                    self.send_error(400)
                    return
                with viewer._lock:
                    if self.path == "/goal":
                        viewer._goal_clicks.append(xy)
                    elif self.path == "/initial_pose":
                        viewer._pose_clicks.append(xy)
                    else:
                        self.send_error(404)
                        return
                self._send(b"{}")

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    # -- host-loop side -----------------------------------------------------
    def publish(self, *, robot_pos, robot_yaw, v, w, decision, planner_state,
                tick, dgraph=None, plan=None, best_rollout=None,
                particles=None, goal=None):
        """Swap in this tick's snapshot (NumPy in, JSON out)."""
        state = {
            "robot": [float(robot_pos[0]), float(robot_pos[1]),
                      float(robot_pos[2]), float(robot_yaw)],
            "v": float(v), "w": float(w),
            "decision": int(decision), "planner_state": int(planner_state),
            "tick": int(tick),
            "dgraph": (np.round(np.asarray(dgraph, np.float32)[self._idx],
                                2).tolist() if dgraph is not None else None),
            "plan": (np.round(np.asarray(plan, np.float32)[:, :2],
                              3).tolist() if plan is not None else None),
            "best_rollout": (np.round(np.asarray(best_rollout, np.float32)
                                      [:, :2], 3).tolist()
                             if best_rollout is not None else None),
            "particles": (np.round(np.asarray(particles, np.float32)[:, :2],
                                   3).tolist()
                          if particles is not None else None),
            "goal": ([float(goal[0]), float(goal[1])]
                     if goal is not None else None),
        }
        self._state_json = json.dumps(state).encode()

    def _snap(self, xy):
        """Raycast the click onto the ground cloud (nearest node in XY) —
        the 3D-goal-tool semantics of `src/dddmr_rviz_tools`."""
        d = np.hypot(self.ground[:, 0] - xy[0], self.ground[:, 1] - xy[1])
        return self.ground[int(np.argmin(d))].copy()

    def pop_goal(self) -> Optional[np.ndarray]:
        with self._lock:
            if not self._goal_clicks:
                return None
            xy = self._goal_clicks.pop(0)
        return self._snap(xy)

    def pop_initial_pose(self) -> Optional[np.ndarray]:
        with self._lock:
            if not self._pose_clicks:
                return None
            xy = self._pose_clicks.pop(0)
        return self._snap(xy)

    def close(self):
        self.server.shutdown()
        self.server.server_close()
