"""The port's span and counter recorder (``runtime/tracing.py``) in the
fleet tick and the fused tick, at CPU sizes: off, a tick calls nothing of
it past the on-check; on, each tick yields its span tree once, with the
same outputs bit for bit; the ``host_reads`` counter counts the fixpoint's
blocks, the marked-cell counters recount the grid against the cap, and
under ``torch.profiler`` each ``span:`` range lies on its span after one
clock offset. The session's and the mapping session's stages are stage
spans of the same recorder."""
import math

import numpy as np
import pytest
import torch

from dddmr_navigation_tpu_torch import entry
from dddmr_navigation_tpu_torch.ops.fixpoint import iterate_to_fixpoint
from dddmr_navigation_tpu_torch.runtime import tracing
from dddmr_navigation_tpu_torch.state_estimation import mcl as tmcl
from dddmr_navigation_tpu_torch.state_estimation import pf as tpf

torch.set_num_threads(2)

FLEET_SPANS = ["tick", "localize", "perceive.mark_clear", "perceive.compose",
               "plan.prepare", "plan.los", "plan.relax", "plan.extract",
               "plan.interpolate", "local", "decide"]
FUSED_SPANS = ["tick", "perceive.mark_clear", "perceive.compose",
               "plan.prepare", "plan.relax", "plan.extract",
               "plan.interpolate", "local"]
RECORDING = ("_begin", "_end", "_mark", "count", "count_device")
# spans inside a layer's span (the LOS gate where it runs), by that layer
NESTED = {"plan.los": "plan.prepare"}


@pytest.fixture(autouse=True)
def fresh_recorder():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _fleet(marked_voxels=128):
    """A config-4 fleet of 2 robots at a test's size, each sweeping a box
    ahead; returns run(state) → (state, diag) with fixed MCL draws."""
    c4 = entry.config4_inputs(
        entry.config4_config(3, 3, 8, 32, 16, 256, 32, 16, marked_voxels,
                             512, 64, 8),
        entry.config4_world(2, 256), "cpu")
    gen = torch.Generator().manual_seed(3)
    state = entry.config4_state(c4, tmcl.init_draws(gen, c4.mcl, 2, "cpu"))
    draws = tpf.draw_mcl(gen, 2, 8, "cpu")

    def run(st, t=1):
        return entry.config4_tick(c4, st, t, draws)
    return c4, state, run


def _fused():
    """The fused tick of config 3 at a test's size, one robot."""
    cfg = entry.config3_config(3, 3, 8, 32, 16, 8, 64, 128, 16)
    c3 = entry.config3_inputs(cfg, "cpu", resolution=1.0)
    pts, m = entry.config3_scan(cfg, entry.config3_world(), c3.robot, 0.0)
    args = (torch.as_tensor(pts)[None], torch.as_tensor(m)[None],
            torch.as_tensor(c3.robot)[None], torch.tensor([[0., 0, 0, 1]]),
            torch.as_tensor(c3.offset), torch.as_tensor(c3.goal)[None],
            torch.zeros(1), torch.zeros(1))

    def run(st):
        return c3.tick(c3.fmap, st, *args)
    return c3, entry.config3_state(c3), run


@pytest.fixture(scope="module")
def fleet():
    return _fleet()


@pytest.fixture(scope="module")
def fused():
    return _fused()


def _kind(request, name):
    return request.getfixturevalue(name)


def _same(a, b) -> bool:
    """Equal trees of tensors, bit for bit (NaNs at the same places)."""
    if isinstance(a, torch.Tensor):
        return (a.dtype == b.dtype and a.shape == b.shape
                and bool(((a == b) | (a != a) & (b != b)).all()))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("kind", ["fleet", "fused"])
def test_recorder_off_calls_nothing_past_the_check(request, monkeypatch,
                                                   kind):
    _, state, run = _kind(request, kind)

    def boom(*a, **k):
        raise AssertionError("a recording function ran with the recorder "
                             "off")
    for name in RECORDING:
        monkeypatch.setattr(tracing, name, boom)
    run(state)
    assert tracing.spans() == [] and tracing.counters() == {}


@pytest.mark.parametrize("kind", ["fleet", "fused"])
def test_each_tick_yields_its_span_tree_once(request, kind):
    _, state, run = _kind(request, kind)
    want = FLEET_SPANS if kind == "fleet" else FUSED_SPANS
    tracing.enable()
    state2, _ = run(state)
    run(state2)
    got = tracing.spans()
    assert [s.name for s in got] == want + want
    for first, tick in ((0, 0), (len(want), 1)):
        root, kids = got[first], got[first + 1:first + len(want)]
        assert root.parent == -1 and root.tick == tick
        layers = [s for s in kids if s.name not in NESTED]
        assert all(s.parent == first and s.tick == tick for s in layers)
        assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
                   for s in kids)
        for s in kids:
            if s.name in NESTED:
                outer = got[s.parent]
                assert outer.name == NESTED[s.name] and s.tick == tick
                assert (outer.start_ns <= s.start_ns <= s.end_ns
                        <= outer.end_ns)
        # the layers run one after another
        assert all(a.end_ns <= b.start_ns for a, b in zip(layers, layers[1:]))


@pytest.mark.parametrize("kind", ["fleet", "fused"])
def test_outputs_and_state_are_bit_identical_on_and_off(request, kind):
    _, state, run = _kind(request, kind)
    off = run(state)
    tracing.enable()
    on = run(state)
    assert tracing.spans()
    assert _same(off, on)


@pytest.mark.parametrize("start, limit, max_iters, block", [
    (0, 5, 64, 16), (0, 15, 64, 16), (0, 16, 64, 16), (0, 40, 64, 16),
    (0, 200, 64, 16), (3, 30, 64, 8)])
def test_host_reads_count_the_fixpoint_blocks(start, limit, max_iters,
                                              block):
    """A step that climbs by one to ``limit`` changes nothing from its
    ``limit - start + 1``-th iteration on (or stops at ``max_iters``): the
    loop reads its flags once a block it ran."""
    x0 = torch.tensor([[float(start)], [float(limit - 2)]])
    tracing.enable()
    with tracing.span("plan.relax"):
        _, iters = iterate_to_fixpoint(
            lambda x: torch.minimum(x + 1, torch.tensor(float(limit))), x0,
            max_iters, block=block)
    ran = min(limit - start + 1, max_iters)
    assert int(iters.max()) == ran
    (s,) = tracing.spans()
    assert s.counts == {"host_reads": math.ceil(ran / block)}
    assert tracing.counters() == {"host_reads": math.ceil(ran / block)}


@pytest.mark.parametrize("kind", ["fleet", "fused"])
def test_host_reads_of_the_relaxation_in_a_tick(request, kind):
    _, state, run = _kind(request, kind)
    tracing.enable()
    _, out = run(state)
    iters = int((out["wf_iters"] if kind == "fleet" else out.wf_iters).max())
    relax = [s for s in tracing.spans() if s.name == "plan.relax"]
    assert len(relax) == 1 and iters > 0
    assert relax[0].counts == {"host_reads": math.ceil(iters / 16)}
    total = sum(s.counts.get("host_reads", 0) for s in tracing.spans())
    assert tracing.counters()["host_reads"] == total


@pytest.mark.parametrize("cap", [128, 6])
def test_marked_counters_recount_the_grid(cap):
    c4, state, run = _fleet(cap)
    tracing.enable()
    state2, _ = run(state)
    got = tracing.counters()
    per_robot = state2.fused.marking.grid.reshape(2, -1).bool().sum(1)
    assert int(per_robot.min()) > 0
    assert got["marked_cells"] == int(per_robot.sum())
    assert got["marked_kept"] == int(per_robot.clamp(max=cap).sum())
    assert (got["marked_kept"] < got["marked_cells"]) == (
        int(per_robot.max()) > cap)
    if cap == 6:
        assert got["marked_kept"] < got["marked_cells"]
    # the counters sum over ticks, still on the device until read
    run(state2)
    assert tracing.counters()["marked_cells"] > got["marked_cells"]


def test_profiler_spans_map_onto_the_recorder_spans(fused):
    _, state, run = fused
    run(state)
    tracing.enable()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(state)
    kept = tracing.spans()
    events = [e for e in prof.events() if e.name.startswith("span:")]
    assert sorted(e.name[5:] for e in events) == sorted(FUSED_SPANS)
    assert all(s.profiled for s in kept)
    off, worst = tracing.clock_offset_ns(prof.events())
    mine = {s.name: s for s in kept}
    gaps = []
    for e in events:
        s = mine[e.name[5:]]
        gaps += [abs(e.time_range.start * 1e3 - (s.start_ns + off)),
                 abs(e.time_range.end * 1e3 - (s.end_ns + off))]
    assert max(gaps) <= 50e3
    assert worst == pytest.approx(max(gaps), abs=1.0)


def test_stage_marks_follow_one_another_under_their_root():
    tracing.enable()
    with tracing.span("tick"):
        tracing.stage("a")
        with tracing.span("inner"):
            pass
        tracing.stage("b")
        tracing.count("host_reads", 2)
    with pytest.raises(ValueError):
        with tracing.span("tick"):
            tracing.stage("c")
            raise ValueError
    tracing.stage("loose")
    tracing.disable()
    tracing.stage("ignored")
    got = tracing.spans()
    assert [(s.name, s.parent, s.tick) for s in got] == [
        ("tick", -1, 0), ("a", 0, 0), ("inner", 1, 0), ("b", 0, 0),
        ("tick", -1, 1), ("c", 4, 1), ("loose", -1, 2)]
    assert got[1].end_ns <= got[3].start_ns and got[3].end_ns == got[0].end_ns
    assert got[5].end_ns == got[4].end_ns      # ended with its root
    assert got[6].end_ns is None               # still open
    assert got[3].counts == {"host_reads": 2}
    assert tracing.stage_seconds(got, "tick") == {
        k: [(s.end_ns - s.start_ns) * 1e-9 for s in got if s.name == k]
        for k in ("a", "b", "c")}


def test_session_stages_are_spans_of_its_tick():
    sc = entry.session_scenario(
        entry.session_config(8, 90, 16, 8, 1, 2, 8), size=(4.0, 3.0),
        room_half=2.5, start=(-1.5, 0, 0), goal=(1.5, 0, 0),
        wall=((-0.1, -0.4, 0), (0.1, 0.4, 1)), no_entry=(-0.3, 0.3, 0.6, 1.2),
        depth_points=32, scan_rings=8, scan_cols=60)
    sess = entry.make_session(sc, "cpu")
    assert not hasattr(sess.driver, "stage")
    tracing.enable()
    try:
        entry.run_session_chain(sess, sc, 2)
    finally:
        sess.close()
    got = tracing.spans()
    roots = [i for i, s in enumerate(got) if s.parent == -1]
    assert [got[i].name for i in roots] == ["tick", "tick"]
    order = ["perception", "depth", "composition+lethal", "plan manager",
             "local tick", "FSM"]
    for i in roots:
        kids = [s.name for s in got if s.parent == i]
        assert kids == [k for k in order if k in kids]
        assert kids[:3] == order[:3] and "FSM" in kids


def test_mapping_chain_reads_its_stages_from_the_recorder():
    from dddmr_navigation_tpu_torch.config import SlamConfig
    sc = entry.slam_scenario(SlamConfig(
        num_horizontal_scans=120, max_less_flat=256, max_keyframes=8,
        max_edges=8, scan_match_iters=2, map_match_iters=2), 2)
    sess = entry.make_mapping_session(sc, "cpu")
    assert not hasattr(sess, "stage")
    mc = entry.run_mapping_chain(sess, sc)
    assert not tracing.on() and tracing.spans() == []
    assert set(mc.stage_s) <= {"frontend", "keyframe", "odometry",
                               "map refine", "loop closure"}
    assert len(mc.stage_s["frontend"]) == 2
    assert "keyframe" in mc.stage_s
    for name, secs in mc.stage_s.items():
        assert all(0.0 <= x <= max(mc.scan_s) for x in secs), name
    assert np.isfinite(mc.scan_s).all()


def test_recording_hands_over_its_spans_and_keeps_none():
    tracing.enable()
    with tracing.span("tick"):
        with tracing.recording() as got:
            with tracing.span("scan"):
                tracing.stage("a")
        tracing.stage("b")
    assert tracing.on()
    assert [(s.name, s.parent) for s in got] == [("scan", -1), ("a", 0)]
    assert [(s.name, s.parent) for s in tracing.spans()] == [
        ("tick", -1), ("b", 0)]
    tracing.disable()
    with tracing.recording() as got:
        assert tracing.on()
        with tracing.span("scan"):
            pass
    assert not tracing.on() and [s.name for s in got] == ["scan"]
    assert len(tracing.spans()) == 2


def test_a_thread_with_no_open_span_counts_outside_the_others_spans():
    """Each thread has its own open spans: a worker's counts never land on
    the span another thread has open, and never race its span's end."""
    import threading
    tracing.enable()
    stop, errors = threading.Event(), []

    def worker():
        try:
            while not stop.is_set():
                tracing.count("worker_reads")
        except Exception as exc:   # pragma: no cover - the failure shown
            errors.append(exc)
    th = threading.Thread(target=worker)
    th.start()
    try:
        for _ in range(2000):
            with tracing.span("tick"):
                with tracing.span("plan.relax"):
                    tracing.count("host_reads")
    finally:
        stop.set()
        th.join()
    assert errors == []
    got = tracing.spans()
    assert len(got) == 4000 and len({s.tick for s in got}) == 2000
    assert all(s.counts == ({"host_reads": 1} if s.name == "plan.relax"
                            else {}) for s in got)
    total = tracing.counters()
    assert total["host_reads"] == 2000 and total["worker_reads"] > 0


def test_threaded_plan_manager_reads_land_outside_the_tick_spans():
    """With the plan manager on its own thread, the session's ticks hold
    only the reads of the tick thread; the worker's relaxations, run with
    no span of its own, are counted apart."""
    import time
    sc = entry.session_scenario(
        entry.session_config(8, 90, 16, 8, 1, 2, 8), size=(4.0, 3.0),
        room_half=2.5, start=(-1.5, 0, 0), goal=(1.5, 0, 0),
        wall=((-0.1, -0.4, 0), (0.1, 0.4, 1)), no_entry=(-0.3, 0.3, 0.6, 1.2),
        depth_points=32, scan_rings=8, scan_cols=60)
    sess = entry.make_session(sc, "cpu", threaded_plan_manager=True)
    pm = sess.driver.plan_manager
    tracing.enable()
    try:
        entry.run_session_chain(sess, sc, 4)   # offers from its third tick
        end = time.monotonic() + 60.0
        while pm.published == 0 and time.monotonic() < end:
            time.sleep(0.05)
    finally:
        sess.close()
        tracing.disable()
    assert pm.published > 0
    got = tracing.spans()
    assert [s.name for s in got if s.parent == -1] == ["tick"] * 4
    assert all(s.end_ns is not None for s in got)
    in_spans = sum(s.counts.get("host_reads", 0) for s in got)
    plan_stage = sum(s.counts.get("host_reads", 0) for s in got
                     if s.name == "plan manager")
    assert plan_stage == 0
    assert tracing.counters()["host_reads"] > in_spans
