"""3D operator surface: orbit viewer + browser pose-graph editing.

The reference's rviz tools render the map cloud in a full 3D viewport
and give Qt panels for interactive pose-graph editing — node/edge
selection, manual ICP between two keyframes, accept/optimize/save
(`src/dddmr_rviz_tools/`, `pose_graph_editor_panel`,
`mapping_panel.cpp:88-106`). The TPU-native equivalent is this
dependency-free HTTP viewer: a perspective orbit canvas (drag = orbit,
wheel = zoom, shift-drag = pan) over the map cloud and the pose graph,
with click-to-select keyframe nodes and keyboard ops that drive
`slam/editor.py`:

  click      toggle-select a keyframe node (up to 2)
  D          delete the edge between the two selected nodes
  I          add an ICP-verified loop edge between them
  O          re-optimize the graph (batch Gauss-Newton)
  C          clear selection

Thread model: HTTP handlers only queue commands and serve the latest
JSON snapshots; the host calls :meth:`poll` (from its own loop) to apply
queued editor ops and republish the graph.

The port's own copy of ``dddmr_navigation_tpu/runtime/viewer3d.py`` (the
standard library and numpy); ``tests/test_torch_runtime_io.py`` holds it
to the original.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>pose graph 3D</title><style>
 body{margin:0;background:#0b0b12;color:#ddd;font:13px monospace;overflow:hidden}
 #hud{position:fixed;top:8px;left:8px;background:#000a;padding:6px 10px;
      border-radius:4px;white-space:pre}
 canvas{display:block}
</style></head><body>
<div id="hud">loading…</div><canvas id="c"></canvas>
<script>
const cv = document.getElementById('c'), hud = document.getElementById('hud');
const ctx = cv.getContext('2d');
let cloud = [], graph = null, log = '';
let yaw = 0.8, pitch = 0.9, dist = 0, pan = [0, 0], center = [0,0,0];
let sel = [];
function fit() { cv.width = innerWidth; cv.height = innerHeight; }
function proj(p) {
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  const x = p[0]-center[0], y = p[1]-center[1], z = p[2]-center[2];
  const x1 = cy*x - sy*y, y1 = sy*x + cy*y;          // yaw about z
  const y2 = cp*y1 - sp*z, z2 = sp*y1 + cp*z;        // pitch
  const zc = y2 + dist;                               // camera depth
  if (zc < 0.3) return null;
  const f = 0.9 * Math.min(cv.width, cv.height);
  return [cv.width/2 + f*x1/zc + pan[0],
          cv.height/2 - f*z2/zc + pan[1], zc];
}
function draw() {
  ctx.fillStyle = '#0b0b12'; ctx.fillRect(0,0,cv.width,cv.height);
  for (const p of cloud) {
    const s = proj(p); if (!s) continue;
    const sh = Math.max(0, Math.min(1, 1.6 - s[2]/dist));
    const zt = Math.max(0, Math.min(1, (p[2]-center[2]+4)/8));
    ctx.fillStyle = `rgb(${40+120*zt*sh|0},${70+90*sh|0},${60+140*(1-zt)*sh|0})`;
    ctx.fillRect(s[0]-1, s[1]-1, 2, 2);
  }
  if (graph) {
    ctx.lineWidth = 1.5;
    for (const [i,j,kind] of graph.edges) {
      const a = proj(graph.nodes[i]), b = proj(graph.nodes[j]);
      if (!a || !b) continue;
      ctx.strokeStyle = kind ? '#f80' : '#3a6';   // loop vs odom
      ctx.beginPath(); ctx.moveTo(a[0],a[1]); ctx.lineTo(b[0],b[1]);
      ctx.stroke();
    }
    graph.nodes.forEach((p, i) => {
      const s = proj(p); if (!s) return;
      ctx.fillStyle = sel.includes(i) ? '#ff4' : '#fff';
      ctx.beginPath(); ctx.arc(s[0], s[1], sel.includes(i)?6:3.3, 0, 7);
      ctx.fill();
    });
  }
  hud.textContent =
    `pose-graph 3D — drag orbit, wheel zoom, shift-drag pan\\n` +
    `click: select node (${sel.join(',')||'none'})\\n` +
    `D delete edge  I add ICP edge  O optimize  C clear\\n` + log;
}
let dragging = false, last = null;
cv.addEventListener('mousedown', e => {dragging = true; last=[e.clientX,e.clientY];});
addEventListener('mouseup', () => dragging = false);
addEventListener('mousemove', e => {
  if (!dragging) return;
  const dx = e.clientX-last[0], dy = e.clientY-last[1];
  last = [e.clientX, e.clientY];
  if (e.shiftKey) { pan[0] += dx; pan[1] += dy; }
  else { yaw += dx*0.008; pitch = Math.max(0.05, Math.min(1.5, pitch + dy*0.008)); }
  draw();
});
cv.addEventListener('wheel', e => { dist *= Math.exp(e.deltaY*0.001); draw(); });
cv.addEventListener('click', e => {
  if (!graph) return;
  let best = -1, bd = 144;
  graph.nodes.forEach((p, i) => {
    const s = proj(p); if (!s) return;
    const d = (s[0]-e.clientX)**2 + (s[1]-e.clientY)**2;
    if (d < bd) { bd = d; best = i; }
  });
  if (best < 0) return;
  if (sel.includes(best)) sel = sel.filter(i => i !== best);
  else { sel.push(best); if (sel.length > 2) sel.shift(); }
  draw();
});
async function cmd(op) {
  await fetch('/cmd', {method:'POST',
    body: JSON.stringify({op, i: sel[0], j: sel[1]})});
}
addEventListener('keydown', e => {
  const k = e.key.toLowerCase();
  if (k === 'c') { sel = []; draw(); }
  if (k === 'd' && sel.length === 2) cmd('delete_edge');
  if (k === 'i' && sel.length === 2) cmd('add_icp_edge');
  if (k === 'o') cmd('optimize');
});
addEventListener('resize', () => {fit(); draw();});
(async () => {
  fit();
  cloud = await (await fetch('/cloud')).json();
  for (;;) {
    try {
      graph = await (await fetch('/graph')).json();
      center = graph.center;
      if (!dist) dist = graph.extent * 1.6;
      log = graph.log;
    } catch (err) {}
    draw();
    await new Promise(r => setTimeout(r, 400));
  }
})();
</script></body></html>"""


class PoseGraph3DViewer:
    """Serve the 3D editor surface over a `slam.editor.GraphEditor`."""

    def __init__(self, editor, map_pts=None, host: str = "127.0.0.1",
                 port: int = 0, max_cloud_points: int = 20000):
        self.editor = editor
        self._cloud = self._subsample(map_pts, max_cloud_points)
        self._cmds: list = []
        self._log: list = []
        self._lock = threading.Lock()
        self._graph_json = b"null"
        self._republish()

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
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
                elif self.path == "/cloud":
                    self._send(viewer._cloud_json)
                elif self.path == "/graph":
                    self._send(viewer._graph_json)
                else:
                    self.send_error(404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    op = str(payload["op"])
                except (ValueError, KeyError):
                    self.send_error(400)
                    return
                with viewer._lock:
                    viewer._cmds.append(payload)
                self._send(b"{}")

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _subsample(self, pts, cap):
        if pts is None:
            self._cloud_json = b"[]"
            return None
        pts = np.asarray(pts, np.float32)
        if len(pts) > cap:
            pts = pts[:: int(np.ceil(len(pts) / cap))]
        self._cloud_json = json.dumps(
            np.round(pts, 2).tolist()).encode()
        return pts

    def _republish(self):
        g = self.editor.graph
        nodes = np.asarray(g.poses[:, :3], np.float32)
        edges = [[int(e["i"]), int(e["j"]), int(e.get("kind") == "loop")]
                 for e in self.editor.edges]
        lo = nodes.min(0) if len(nodes) else np.zeros(3)
        hi = nodes.max(0) if len(nodes) else np.ones(3)
        self._graph_json = json.dumps({
            "nodes": np.round(nodes, 3).tolist(),
            "edges": edges,
            "center": np.round((lo + hi) / 2.0, 2).tolist(),
            "extent": float(max(np.max(hi - lo), 1.0)),
            "log": "\n".join(self._log[-4:]),
        }).encode()

    # -- host-loop side -----------------------------------------------------
    def poll(self) -> int:
        """Apply queued editor ops (call from the host thread, the analogue
        of the rviz panel's accept buttons driving the editor node).
        Returns the number of ops applied."""
        with self._lock:
            cmds, self._cmds = self._cmds, []
        applied = 0
        for c in cmds:
            op = c.get("op")
            try:
                if op == "delete_edge":
                    ok = self.editor.delete_edge(int(c["i"]), int(c["j"]))
                    self._log.append(
                        f"delete_edge({c['i']},{c['j']}) -> {ok}")
                elif op == "add_icp_edge":
                    self.editor.add_icp_edge(int(c["i"]), int(c["j"]))
                    self._log.append(f"add_icp_edge({c['i']},{c['j']}) ok")
                elif op == "optimize":
                    self.editor.optimize()
                    self._log.append("optimize ok")
                else:
                    self._log.append(f"unknown op {op}")
                    continue
                applied += 1
            except Exception as e:  # surface editor failures to the page
                self._log.append(f"{op} FAILED: {type(e).__name__}: {e}")
        if applied:
            self._republish()
        return applied

    def close(self):
        self.server.shutdown()
        self.server.server_close()
