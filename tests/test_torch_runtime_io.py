"""The port's host runtime and the rest of ``io/`` against the JAX
package, on the CPU: the copies (``runtime/actions.py``, ``viewer.py``,
``viewer3d.py``, ``io/rosbag.py``, ``io/native.py``, the map builders),
the checkpoint files (the JAX package's format, read and written by
either), tracing over ``torch.profiler``, and the functions the earlier
slices skipped (``pad_graph``, ``lookup_range``, ``post_smooth_path``).

Mirrors ``tests/test_runtime.py``, ``test_viewer.py``, ``test_native.py``,
``test_rosbag.py::test_pointcloud2_roundtrip`` and the synthetic-map tests
of ``test_io_config.py``. Every comparison with the JAX package is exact.
"""
import importlib.util
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dddmr_navigation_tpu.io import maps as jmaps
from dddmr_navigation_tpu.io import native as jnative
from dddmr_navigation_tpu.io import rosbag as jrosbag
from dddmr_navigation_tpu.perception import fov as jfov
from dddmr_navigation_tpu.planning.global_ import graph as jgraph
from dddmr_navigation_tpu.planning.global_.planner import (
    post_smooth_path as j_post_smooth_path)
from dddmr_navigation_tpu.runtime import checkpoint as jckpt

from dddmr_navigation_tpu_torch import entry
from dddmr_navigation_tpu_torch.io import maps as tmaps
from dddmr_navigation_tpu_torch.io import native as tnative
from dddmr_navigation_tpu_torch.io import rosbag as trosbag
from dddmr_navigation_tpu_torch.io import (
    corridor_map, flat_ground_map, box_obstacle, voxel_downsample, write_pcd)
from dddmr_navigation_tpu_torch.perception import fov as tfov
from dddmr_navigation_tpu_torch.planning.global_ import graph as tgraph
from dddmr_navigation_tpu_torch.planning.global_.planner import (
    post_smooth_path)
from dddmr_navigation_tpu_torch.runtime import (
    ActionClient, ActionServer, CheckpointManager, DebugDumper,
    FreshnessGate, GetPlanGoal, GoalStatus, NavViewer, PeriodicTimer,
    PoseGraph3DViewer, TickMonitor, restore_pytree, save_pytree, trace)
from dddmr_navigation_tpu_torch.runtime.checkpoint import tree_flatten
from dddmr_navigation_tpu_torch.state_estimation.pf import PFState

TESTS = os.path.dirname(os.path.abspath(__file__))


def _load_test_module(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(TESTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# actions, timers, watchdogs (tests/test_runtime.py)
# ---------------------------------------------------------------------------

def test_action_success_and_result():
    def execute(goal, handle):
        handle.publish_feedback("planning")
        handle.succeed(result={"path": [goal.goal, 1, 2]})

    srv = ActionServer("get_plan", execute)
    status, result = ActionClient(srv).call(GetPlanGoal(goal=0), timeout=5.0)
    assert status == GoalStatus.SUCCEEDED
    assert result["path"] == [0, 1, 2]


def test_action_preemption():
    started = []

    def execute(goal, handle):
        started.append(goal)
        while not handle.is_cancel_requested():
            time.sleep(0.01)
        handle.canceled()

    srv = ActionServer("move", execute)
    h1 = srv.submit("goal1")
    time.sleep(0.05)
    h2 = srv.submit("goal2")   # preempts goal1
    assert h1.wait(timeout=5.0)[0] == GoalStatus.CANCELED
    h2.cancel()
    assert h2.wait(timeout=5.0)[0] == GoalStatus.CANCELED
    assert started == ["goal1", "goal2"]


def test_action_exception_aborts():
    def execute(goal, handle):
        raise RuntimeError("boom")

    status, result = ActionServer("bad", execute).submit(None).wait(
        timeout=5.0)
    assert status == GoalStatus.ABORTED
    assert isinstance(result, RuntimeError)


def test_periodic_timer_rate():
    hits = []
    t = PeriodicTimer(50.0, lambda: hits.append(time.monotonic()))
    t.start()
    time.sleep(0.25)
    t.stop()
    assert 5 <= len(hits) <= 20


def test_freshness_gate_and_tick_monitor():
    g = FreshnessGate(expected_dt={"lidar": 0.2, "odom": 0.1})
    assert not g.ok()
    g.update("lidar", 100.0)
    g.update("odom", 100.0)
    assert g.ok(100.05) and not g.ok(100.15)
    assert g.is_current("lidar", 100.15)
    m = TickMonitor(budget_ms=1.0)
    for i in range(10):
        m.start()
        if i == 0:
            time.sleep(0.003)
        m.stop()
    s = m.stats()
    assert s["ticks"] == 10 and s["deadline_misses"] >= 1
    assert s["p50_ms"] <= s["p99_ms"] <= s["max_ms"]


def test_runtime_exports_match():
    import dddmr_navigation_tpu.runtime as jrt
    import dddmr_navigation_tpu_torch.runtime as trt
    want = {n for n in dir(jrt) if not n.startswith("_")}
    assert want <= set(dir(trt))


# ---------------------------------------------------------------------------
# checkpoints: the JAX package's file format, both ways
# ---------------------------------------------------------------------------

def _jax_particles():
    from dddmr_navigation_tpu.config import MCLConfig
    from dddmr_navigation_tpu.state_estimation import init_particles
    return init_particles(jax.random.PRNGKey(0), MCLConfig(num_particles=16),
                          jnp.zeros(3), jnp.asarray([0.0, 0.0, 0.0, 1.0]))


def test_checkpoint_crosses_both_ways(tmp_path):
    """A JAX particle set saved by the JAX package restores into the port's
    ``PFState``; the port's save restores in the JAX package; the leaf
    order is ``jax.tree_util``'s (NamedTuple fields in order, dict keys
    sorted)."""
    jp = _jax_particles()
    path = str(tmp_path / "jax_state")
    jckpt.save_pytree(path, jp)
    template = PFState(*(torch.zeros(np.shape(x)) for x in jp))
    got = restore_pytree(path, template)
    assert isinstance(got, PFState)
    for g, w in zip(got, jp):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    path2 = str(tmp_path / "port_state")
    tree = {"b": got, "a": [torch.arange(3), 2.5], "c": None}
    save_pytree(path2, tree)
    meta = json.load(open(path2 + ".meta.json"))
    assert meta["num_leaves"] == len(jp) + 2
    jtree = {"b": jp, "a": [jnp.zeros(3, jnp.int32), 0.0], "c": None}
    back = jckpt.restore_pytree(path2, jtree)
    np.testing.assert_array_equal(np.asarray(back["a"][0]), [0, 1, 2])
    assert float(back["a"][1]) == 2.5
    for g, w in zip(back["b"], jp):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert len(tree_flatten(tree)[0]) == len(jax.tree_util.tree_leaves(jtree))


def test_checkpoint_roundtrip_keeps_dtype_and_device(tmp_path):
    state = PFState(*(torch.rand(2, 5) for _ in PFState._fields))
    state = state._replace(pos=torch.rand(2, 5, 3, dtype=torch.float64))
    path = str(tmp_path / "state")
    save_pytree(path, state)
    template = PFState(*(torch.zeros_like(x) for x in state))
    back = restore_pytree(path, template)
    for a, b in zip(back, state):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def test_checkpoint_manager_rotation(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": torch.arange(4), "b": torch.ones((2, 2))}
    for step in range(5):
        m.save(step, {"a": torch.arange(4) + step, "b": torch.ones((2, 2))})
    assert m.latest_step() == 4
    step, restored = m.restore_latest(tree)
    assert step == 4
    assert torch.equal(restored["a"], torch.arange(4) + 4)
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".npz")]) == 2
    empty = CheckpointManager(str(tmp_path / "none"))
    assert empty.restore_latest(tree) == (None, None)


def test_session_checkpoint_restores_the_next_tick(tmp_path):
    """``NavigationSession.checkpoint_state()`` through a CheckpointManager:
    a session whose device state is restored from the file ticks as the
    original does."""
    cfg = entry.session_config(16, 180, 32, 16, 2, 4, 32)
    sc = entry.session_scenario(
        cfg, size=(6.0, 4.0), room_half=2.8, start=(-1.4, 0.0, 0.0),
        goal=(2.2, 0.0, 0.0), wall=((-0.1, -0.6, 0.0), (0.1, 0.6, 1.2)),
        no_entry=(-0.5, 0.5, 0.8, 1.8), slow_from=1.0, depth_points=128,
        scan_rings=12, scan_cols=120)
    r = entry.session_checkpoint_round_trip(sc, str(tmp_path / "ck"),
                                            ticks=3, device="cpu")
    assert r["step"] == 3 and r["same_state"]
    assert r["out_a"] == r["out_b"]


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def test_trace_writes_a_profile(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    assert any("mm" in e.key for e in prof.key_averages())
    assert json.load(open(tmp_path / "tr" / files[0]))["traceEvents"]


def test_debug_dumper_ring_with_tensors(tmp_path):
    """The rviz-topic analogue: tensors dumped to the host as npz, a ring
    of ``keep`` files that ``tools/viz_dump.py`` renders."""
    import sys
    sys.path.insert(0, os.path.dirname(TESTS))
    from tools.viz_dump import render_dump_dir

    ground = flat_ground_map(6, 4, 0.5)
    dump = DebugDumper(str(tmp_path / "ring"), keep=2)
    for t in range(3):
        dump.dump(t, ground=torch.from_numpy(ground),
                  dgraph=torch.full((len(ground),), 9999.0),
                  robot=np.array([0.0, 0.0, 0.0]), plan=torch.zeros((5, 3)))
    names = sorted(os.listdir(tmp_path / "ring"))
    assert names == ["tick_00000001.npz", "tick_00000002.npz"]
    np.testing.assert_array_equal(
        np.load(tmp_path / "ring" / names[0])["ground"], ground)
    outs = render_dump_dir(str(tmp_path / "ring"), str(tmp_path / "png"))
    assert len(outs) == 2
    assert DebugDumper(str(tmp_path / "off"), enabled=False).dump(0) is None


# ---------------------------------------------------------------------------
# the viewers (tests/test_viewer.py)
# ---------------------------------------------------------------------------

def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read()


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read()


def test_viewer_serves_map_state_and_click_commands():
    ground = flat_ground_map(10, 6, 0.25)
    viewer = NavViewer(ground, port=0)
    try:
        assert b"canvas" in _get(viewer.port, "/")
        m = json.loads(_get(viewer.port, "/map"))
        assert len(m["ground"]) > 100 and len(m["bounds"]) == 4
        assert json.loads(_get(viewer.port, "/state")) is None
        viewer.publish(robot_pos=[1.0, 2.0, 0.0], robot_yaw=0.3, v=0.4,
                       w=0.1, decision=4, planner_state=4, tick=7,
                       dgraph=np.full((len(ground),), 9999.0),
                       plan=np.array([[0, 0, 0], [1, 0, 0]], np.float32),
                       goal=[4.0, 0.0, 0.0])
        st = json.loads(_get(viewer.port, "/state"))
        assert st["tick"] == 7 and st["decision"] == 4
        assert len(st["dgraph"]) == len(m["ground"])
        _post(viewer.port, "/goal", {"x": 3.07, "y": -1.18})
        g = viewer.pop_goal()
        d = np.hypot(ground[:, 0] - 3.07, ground[:, 1] + 1.18)
        np.testing.assert_allclose(g, ground[int(np.argmin(d))])
        assert viewer.pop_goal() is None
        _post(viewer.port, "/initial_pose", {"x": -4.9, "y": 2.9})
        p = viewer.pop_initial_pose()
        assert p is not None and abs(p[0] + 4.9) < 0.3
    finally:
        viewer.close()


def test_viewer3d_drives_the_port_graph_editor():
    """The browser pose-graph editing surface over the port's
    ``slam.editor.GraphEditor``: add an ICP loop edge between two selected
    keyframes, optimize, delete it again, all over HTTP."""
    from dddmr_navigation_tpu_torch.slam.editor import GraphEditor
    from dddmr_navigation_tpu_torch.state_estimation.submaps import PoseGraph
    rng = np.random.default_rng(0)
    world = rng.uniform(-4, 4, (256, 3)).astype(np.float32)
    poses = np.zeros((6, 8), np.float32)
    feats, grounds = [], []
    for i in range(6):
        true_p = np.array([1.0 * i, 0.0, 0.0], np.float32)
        poses[i, :3] = true_p + np.array([0.0, 0.06 * i, 0.0], np.float32)
        feats.append(world - true_p[None, :])
        grounds.append((world - true_p[None, :]) * np.float32(0.5))
    ed = GraphEditor.from_graph(PoseGraph(poses=poses, feature_clouds=feats,
                                          ground_clouds=grounds), "cpu")
    v = PoseGraph3DViewer(ed, map_pts=world, port=0)
    try:
        page = _get(v.port, "/")
        assert b"canvas" in page and b"add_icp_edge" in page
        assert len(json.loads(_get(v.port, "/cloud"))) == len(world)
        graph = json.loads(_get(v.port, "/graph"))
        assert len(graph["nodes"]) == 6
        n0 = len(graph["edges"])
        _post(v.port, "/cmd", {"op": "add_icp_edge", "i": 0, "j": 5})
        err_before = abs(float(ed.graph.poses[5, 1]))
        assert v.poll() == 1 and len(ed.edges) == n0 + 1
        ed.edges[-1]["weight"] = 50.0
        _post(v.port, "/cmd", {"op": "optimize"})
        assert v.poll() == 1
        assert abs(float(ed.graph.poses[5, 1])) < 0.5 * err_before
        graph = json.loads(_get(v.port, "/graph"))
        assert any(kind == 1 for _, _, kind in graph["edges"])
        assert "optimize ok" in graph["log"]
        _post(v.port, "/cmd", {"op": "delete_edge", "i": 0, "j": 5})
        assert v.poll() == 1 and len(ed.edges) == n0
    finally:
        v.close()


# ---------------------------------------------------------------------------
# native host runtime (tests/test_native.py), and its fallbacks
# ---------------------------------------------------------------------------

needs_native = pytest.mark.skipif(not tnative.native_available(),
                                  reason="native lib unavailable")


@needs_native
def test_native_pcd_and_knn_equal_the_jax_package(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 10, (257, 4)).astype(np.float32)
    for binary in (True, False):
        p = str(tmp_path / f"t_{binary}.pcd")
        write_pcd(p, pts, fields=("x", "y", "z", "intensity"), binary=binary)
        back = tnative.read_pcd_native(p)
        np.testing.assert_array_equal(back, jnative.read_pcd_native(p))
        np.testing.assert_allclose(back, pts, atol=1e-4)
    cloud = rng.uniform(0, 8, (800, 3)).astype(np.float32)
    for a, b in zip(tnative.build_knn_graph_native(cloud, 0.6, 8, 8),
                    jnative.build_knn_graph_native(cloud, 0.6, 8, 8)):
        np.testing.assert_array_equal(a, b)
    idx, dist = tnative.build_knn_graph_native(
        np.array([[0, 0, 0], [1, 0, 0], [0, 2, 0], [5, 5, 5]], np.float32),
        radius=2.5, k=3, orphan_k=2)
    assert idx[0, 0] == 1 and np.isclose(dist[0, 0], 1.0)
    assert idx[0, 1] == 2 and np.isclose(dist[0, 1], 2.0)


def test_native_fallbacks_equal_the_jax_package(tmp_path, monkeypatch):
    """Without the library, the port falls back to its own ``io/pcd.py``
    and ``build_ground_graph``, as the JAX package falls back to its."""
    monkeypatch.setattr(tnative, "_LIB", False)
    monkeypatch.setattr(jnative, "_LIB", False)
    assert not tnative.native_available()
    rng = np.random.default_rng(1)
    pts = rng.normal(0, 3, (64, 3)).astype(np.float32)
    p = str(tmp_path / "f.pcd")
    write_pcd(p, pts, binary=True)
    np.testing.assert_array_equal(tnative.read_pcd_native(p),
                                  jnative.read_pcd_native(p))
    cloud = rng.uniform(0, 4, (300, 3)).astype(np.float32)
    for a, b in zip(tnative.build_knn_graph_native(cloud, 0.6, 8, 8),
                    jnative.build_knn_graph_native(cloud, 0.6, 8, 8)):
        np.testing.assert_array_equal(a, b)
    ring = tnative.SensorRing()
    assert ring.pop() is None and ring.push(np.arange(3))
    np.testing.assert_array_equal(ring.pop(), np.arange(3))


@needs_native
def test_spsc_ring_threaded_and_bounded():
    ring = tnative.SensorRing(1 << 20)
    got = []

    def producer():
        for i in range(200):
            while not ring.push(np.full((16,), i, np.float32)):
                pass

    def consumer():
        while len(got) < 200:
            m = ring.pop()
            if m is not None:
                got.append(int(m[0]))

    ts = [threading.Thread(target=producer), threading.Thread(target=consumer)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=10)
    assert got == list(range(200))
    small = tnative.SensorRing(256)
    assert small.pop() is None
    assert not small.push(np.zeros((1024,), np.float32))
    assert small.push(np.arange(8, dtype=np.float32))
    np.testing.assert_array_equal(small.pop(), np.arange(8, dtype=np.float32))


@needs_native
def test_realtime_executor_paces_and_accounts():
    hits = []

    def cb(i):
        hits.append(i)
        if i == 3:
            time.sleep(0.03)   # one deadline miss at 100 Hz

    ex = tnative.RealtimeExecutor(100.0, cb)
    ex.start()
    time.sleep(0.35)
    ex.stop()
    s = ex.stats()
    ex.close()
    assert s["error"] is None
    assert 20 <= s["ticks"] <= 40, s
    assert s["deadline_misses"] >= 1 and s["max_ms"] >= 25.0
    assert hits == sorted(hits)


# ---------------------------------------------------------------------------
# rosbag (tests/test_rosbag.py::test_pointcloud2_roundtrip)
# ---------------------------------------------------------------------------

def test_pointcloud2_roundtrip():
    make = _load_test_module("test_rosbag")._make_pointcloud2_cdr
    pts = np.array([[1.0, 2.0, 3.0], [-4.0, 5.5, 0.25]], np.float32)
    buf = make(pts)
    msg = trosbag.parse_pointcloud2(buf)
    assert msg["frame_id"] == "velodyne"
    assert msg["field_names"] == ["x", "y", "z", "intensity"]
    np.testing.assert_allclose(msg["points"][:, :3], pts)
    np.testing.assert_allclose(msg["points"][:, 3], [0.0, 1.0])
    assert abs(msg["stamp"] - 7.0000005) < 1e-6
    want = jrosbag.parse_pointcloud2(buf)
    assert msg.keys() == want.keys()
    np.testing.assert_array_equal(msg["points"], want["points"])


def test_rosbag_reader_on_a_written_database(tmp_path):
    """The sqlite3 rosbag2 layout: topics and CDR messages read back by
    the port's ``BagReader`` as by the JAX package's."""
    import sqlite3
    make = _load_test_module("test_rosbag")._make_pointcloud2_cdr
    db = tmp_path / "bag_0.db3"
    con = sqlite3.connect(db)
    con.execute("CREATE TABLE topics (id INTEGER PRIMARY KEY, name TEXT, "
                "type TEXT, serialization_format TEXT, "
                "offered_qos_profiles TEXT)")
    con.execute("CREATE TABLE messages (id INTEGER PRIMARY KEY, topic_id "
                "INTEGER, timestamp INTEGER, data BLOB)")
    con.execute("INSERT INTO topics VALUES (1, '/points', "
                "'sensor_msgs/msg/PointCloud2', 'cdr', '')")
    for i in range(3):
        pts = np.full((4, 3), i, np.float32)
        con.execute("INSERT INTO messages VALUES (?, 1, ?, ?)",
                    (i + 1, 1000 + i, make(pts)))
    con.commit()
    con.close()
    tb, jb = trosbag.BagReader(str(tmp_path)), jrosbag.BagReader(str(tmp_path))
    assert tb.count() == jb.count() == 3
    got = list(tb.messages("/points"))
    want = list(jb.messages("/points"))
    assert len(got) == len(want) == 3
    for (ts_, tt, tm), (js_, jt, jm) in zip(got, want):
        assert (ts_, tt) == (js_, jt)
        np.testing.assert_array_equal(tm["points"], jm["points"])
    tb.close()
    jb.close()


# ---------------------------------------------------------------------------
# maps, the graph, the FOV lookup, the path smoother
# ---------------------------------------------------------------------------

def test_synthetic_maps_equal_the_jax_package():
    g = flat_ground_map(10, 10, 0.5)
    assert g.shape[1] == 3 and len(g) == 21 * 21
    ground, walls = corridor_map()
    assert walls[:, 2].max() >= 1.9
    for a, b in zip(corridor_map(), jmaps.corridor_map()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tmaps.corridor_map(12.0, 3.0, 0.2, 1.5)[1],
        jmaps.corridor_map(12.0, 3.0, 0.2, 1.5)[1])
    for kw in ({}, {"size_x": 12.0, "resolution": 0.5, "height": 1.0}):
        np.testing.assert_array_equal(tmaps.ramp_ground_map(**kw),
                                      jmaps.ramp_ground_map(**kw))
    assert len(box_obstacle((1.0, 0.0, 0.0))) > 0
    pts = np.array([[0.01, 0.01, 0.0], [0.02, 0.02, 0.0], [1.0, 1.0, 0.0]],
                   np.float32)
    assert voxel_downsample(pts, 0.1).shape[0] == 2


def test_pad_graph_equals_the_jax_package():
    ground = tmaps.ramp_ground_map(6.0, 3.0, 0.5)
    tg = tgraph.build_ground_graph(ground, radius=0.6, k_max=8)
    jg = jgraph.build_ground_graph(ground, radius=0.6, k_max=8)
    a = tgraph.pad_graph(tg, len(ground) + 7)
    b = jgraph.pad_graph(jg, len(ground) + 7)
    for f in tgraph.GroundGraph._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), f)
    assert (a.nbr_idx[len(ground):] == -1).all()
    with pytest.raises(AssertionError):
        tgraph.pad_graph(tg, len(ground) - 1)


def test_lookup_range_equals_the_jax_package():
    spec_t = tfov.RangeImageSpec(16, 90, -15.0, 15.0, 30.0)
    spec_j = jfov.RangeImageSpec(16, 90, -15.0, 15.0, 30.0)
    rng = np.random.default_rng(3)
    img = rng.uniform(0.5, 30.0, (16, 90)).astype(np.float32)
    elev = rng.uniform(-20.0, 20.0, 4000).astype(np.float32)
    azim = rng.uniform(-180.0, 180.0, 4000).astype(np.float32)
    elev[:3] = [-15.0, 15.0, 0.0]
    azim[:3] = [-180.0, 179.999, 0.0]
    want = np.asarray(jax.jit(lambda i, e, a: jfov.lookup_range(
        spec_j, i, e, a))(img, elev, azim))
    got = tfov.lookup_range(spec_t, torch.from_numpy(img),
                            torch.from_numpy(elev), torch.from_numpy(azim))
    np.testing.assert_array_equal(got.numpy(), want)


def _smooth_inputs():
    gx, gy = np.meshgrid(np.arange(-0.5, 3.51, 0.2),
                         np.arange(-0.6, 0.61, 0.2))
    ground = np.stack([gx.ravel(), gy.ravel(),
                       np.zeros(gx.size)], 1).astype(np.float32)
    xs = np.arange(0, 3.01, 0.25, dtype=np.float32)
    ids = [int(np.argmin(np.sum((ground - [x, 0, 0]) ** 2, 1))) for x in xs]
    return ground, ids


@pytest.mark.parametrize("case", ["open", "obstacle", "ramp", "short"])
def test_post_smooth_path_equals_the_jax_package(case):
    """``tests/test_global_planner.py``'s inputs: on open ground a straight
    run collapses to its ends; an obstacle cluster on the midline keeps
    interior nodes; a steep step keeps them too."""
    ground, ids = _smooth_inputs()
    wall = np.zeros((0, 3))
    if case == "obstacle":
        wall = np.array([[1.5, 0.0, 0.0], [1.5, 0.05, 0.0],
                         [1.55, 0.0, 0.0]], np.float32)
    elif case == "ramp":
        ground = ground.copy()
        ground[:, 2] = np.where(ground[:, 0] > 1.6, 0.8, 0.0)
    elif case == "short":
        ids = ids[:2]
    got = post_smooth_path(ground, wall, ids)
    assert got == j_post_smooth_path(ground, wall, ids)
    assert got[0] == ids[0] and got[-1] == ids[-1]
    if case == "open":
        assert len(got) < len(ids)
    elif case in ("obstacle", "ramp"):
        assert len(got) > 2
