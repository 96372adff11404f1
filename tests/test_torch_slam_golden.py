"""The port's mapping session at full width (``SlamConfig()``: a 16×1000
range image, 256 keyframes) against the JAX package's recorded run
(``dddmr_navigation_tpu_torch/testdata/slam_golden.npz``, written by
``tools/make_slam_golden.py``), on the CPU, teacher-forced: each replayed
scan starts from the state the JAX session started it from. No JAX is
compiled; the scans are regenerated with the port's ``lidar_sim``.

Replayed: a plain scan, a keyframe scan, the first loop-closure scan
(its ICP and the 256-node pose-graph solve) and the last scan, then the
final state's ``save``. Tolerances: the frontend's features equal the
recorded keyframe features bit for bit; poses (odometry, refinement, ICP,
the graph, the scan's end) within 1e-5; keyframe, loop and edge integers
exact; the saved poses equal.
"""
import os

import numpy as np
import pytest
import torch

from dddmr_navigation_tpu_torch import entry
from dddmr_navigation_tpu_torch.interop import (
    port_mapping_state, tick_of)
from dddmr_navigation_tpu_torch.state_estimation.submaps import (
    read_pose_graph)

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dddmr_navigation_tpu_torch", "testdata", "slam_golden.npz")
TOL = 1e-5


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def sc():
    return entry.slam_scenario()


def test_golden_scenario_is_the_port_scenario(golden, sc):
    """The recorded loop is ``entry.slam_scenario()``'s, its recorded scan
    equals the one ``lidar_sim`` regenerates, and the JAX run it records
    makes ≥ 17 keyframes, closes a loop and ends within 0.5 m."""
    np.testing.assert_array_equal(golden["true_pos"], sc.true_pos)
    np.testing.assert_array_equal(golden["true_yaw"], sc.true_yaw)
    pts, mask = entry.slam_scan(sc, int(golden["scan_t"]))
    np.testing.assert_array_equal(pts, golden["scan_points"])
    np.testing.assert_array_equal(mask, golden["scan_mask"])
    assert int(golden["out_n_keyframes"][-1]) >= 17
    assert int(golden["out_n_loops"][-1]) >= 1
    p, _ = entry.slam_truth(sc, sc.scans - 1)
    assert np.linalg.norm(golden["out_pos"][-1][:2] - p[:2]) < 0.5


def _replay(golden, sc, t):
    return entry.replay_mapping(sc, golden, [t], device="cpu")[t]


def _check_scan(golden, sess, t):
    out = tick_of(golden, t, prefix="out_")
    last = sess.last_scan
    assert bool(last["keyframe"]) == bool(out["keyframe"]), t
    assert sess.n_keyframes == int(out["n_keyframes"]), t
    assert sess.n_edges == int(out["n_edges"]), t
    assert len(sess.loop_closures) == int(out["n_loops"]), t
    if out["keyframe"]:
        # the scan's features are the keyframe's recorded features
        k = sess.n_keyframes - 1
        for name in last["feats"]._fields:
            np.testing.assert_array_equal(
                getattr(last["feats"], name).numpy(), golden[f"kf_{name}"][k],
                err_msg=f"scan {t} {name}")
    for key in ("odom", "refined"):
        assert (key in last) == bool(out[f"has_{key}"]), (t, key)
        if key in last:
            np.testing.assert_allclose(last[key][0], out[f"{key}_pos"],
                                       atol=TOL, rtol=0)
            np.testing.assert_allclose(last[key][1], out[f"{key}_quat"],
                                       atol=TOL, rtol=0)
    cand = last.get("loop_candidate", (-1, False))
    assert (cand[0] if cand[1] else -1, cand[1]) == (
        int(out["cand"]) if out["found"] else -1, bool(out["found"])), t
    assert ("icp" in last) == bool(out["has_icp"]), t
    if "icp" in last:
        pos, quat, fit = last["icp"]
        np.testing.assert_allclose(pos.numpy(), out["icp_pos"], atol=TOL)
        np.testing.assert_allclose(quat.numpy(), out["icp_quat"], atol=TOL)
        assert abs(fit - float(out["icp_fitness"])) <= TOL * max(1.0, fit)
    assert ("graph" in last) == bool(out["has_graph"]), t
    if "graph" in last:
        np.testing.assert_allclose(last["graph"].pos.numpy(),
                                   out["graph_pos"], atol=TOL, rtol=0)
        np.testing.assert_allclose(last["graph"].quat.numpy(),
                                   out["graph_quat"], atol=TOL, rtol=0)
    np.testing.assert_allclose(sess.cur_pos, out["pos"], atol=TOL, rtol=0)
    np.testing.assert_allclose(sess.cur_quat, out["quat"], atol=TOL, rtol=0)


def _first(golden, key, after=0):
    return next(t for t in range(after, len(golden["out_keyframe"]))
                if golden[key][t])


@pytest.mark.parametrize("which", ["plain", "keyframe", "loop", "last"])
def test_golden_scan_teacher_forced(golden, sc, which):
    t = {"plain": lambda: next(
            t for t in range(1, len(golden["out_keyframe"]))
            if not golden["out_keyframe"][t]),
         "keyframe": lambda: _first(golden, "out_keyframe", 1),
         "loop": lambda: _first(golden, "out_has_graph"),
         "last": lambda: len(golden["out_keyframe"]) - 1}[which]()
    sess = _replay(golden, sc, t)
    _check_scan(golden, sess, t)
    if which == "loop":
        assert sess.last_scan["icp"][2] <= sc.cfg.history_keyframe_fitness_score


@pytest.fixture(scope="module")
def final_session(golden, sc):
    """The JAX run's final state: its last scan replayed teacher-forced."""
    n = len(golden["out_keyframe"])
    sess = port_mapping_state(tick_of(golden, n - 1, prefix="state_"),
                              sc.cfg, "cpu", keyframes=golden)
    sess.process_scan(*entry.slam_scan(sc, n - 1))
    return sess


def test_golden_save(golden, final_session, tmp_path):
    """The final state's ``save`` writes JAX's poses, each keyframe's
    corner features and its patched ground."""
    final_session.save(str(tmp_path / "pg"))
    g = read_pose_graph(str(tmp_path / "pg"))
    np.testing.assert_allclose(g.poses, golden["saved_poses"], atol=TOL,
                               rtol=0)
    lens = golden["kf_ground__len"]
    starts = np.concatenate([[0], np.cumsum(lens)])
    for i in range(len(g.poses)):
        m = golden["kf_less_sharp_mask"][i]
        np.testing.assert_array_equal(g.feature_clouds[i],
                                      golden["kf_less_sharp"][i][m])
        np.testing.assert_array_equal(
            g.ground_clouds[i], golden["kf_ground"][starts[i]:starts[i + 1]])


def test_golden_map_localizes(final_session, sc):
    """MCL on the saved map along the mapped route
    (``entry.run_slam_localization``, four generator seeds): finite
    estimates, and the median final error within JAX's largest over keys
    0-15, 3.59 m (``tools/slam_localization_rate.py``: the corner-only map
    keeps neither package within 0.5 m)."""
    passes = entry.run_slam_localization(
        sc, final_session.pose_graph(),
        [torch.Generator().manual_seed(s) for s in range(4)], device="cpu")
    errs = np.asarray([[e for _, e, _ in p] for p in passes])
    assert errs.shape == (4, entry.SLAM_LOC_TICKS)
    assert np.isfinite(errs).all()
    assert float(np.median(errs[:, -1])) <= 3.59, errs[:, -1]
