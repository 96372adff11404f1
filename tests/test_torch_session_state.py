"""The navigation session's state as one tree (``control/session.py::
SessionState``) and its tick as a function of (state, inputs)
(``NavigationSession.step``), on the CPU at the delivery cell's CPU cut
(``navbench/configs/session1.json`` with ``navbench/tiny/session1.json``):
the tour's first 20 ticks cross a goal change at a dock, and a planner
patience of 0.05 s sends each wait for a plan into the rotate recovery.
The session golden file (``test_torch_session_golden.py``) holds
``tick()`` to what it returned before."""
import copy
import json
import os

import numpy as np
import pytest
import torch

from dddmr_navigation_tpu_torch import entry
from dddmr_navigation_tpu_torch.config import NavigationConfig
from navbench import spec
from navbench.run import PROGRAM, REFERENCE, diff, reading, to_side
from navbench.world import build_world

TICKS = 20
SEED = 2 ** 31 + 21


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else copy.deepcopy(v))
    return out


def cut_config(period_ticks: int = 48, **navigation) -> tuple:
    """The session cell's (configuration, traffic parameters) at its CPU
    cut, a ``period_ticks``-tick period and ``navigation`` merged in."""
    config = spec.load_config("session1")
    with open(os.path.join(spec.HERE, "tiny", "session1.json")) as f:
        cut = json.load(f)
    traffic = _merge(spec.load_traffic("session1-delivery"),
                     {**cut.pop("traffic", {}),
                      "period_ticks": period_ticks})
    config = _merge(_merge(config, cut), {"navigation": navigation})
    return config, traffic


def _cell(period_ticks: int = 48, **navigation):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, params = cut_config(period_ticks, **navigation)
    world = build_world(config["map"])
    traffic = spec.load_generator(params["generator"])(
        world, config, params, SEED, "cpu")
    return config, world, traffic


@pytest.fixture(scope="module")
def cell():
    return _cell(move_base={"planner_patience": 0.05})


@pytest.fixture(scope="module")
def patient_cell():
    """The cut with the configuration's own patience: no recovery."""
    return _cell()


def _side(cell, pkg):
    config, world, traffic = cell
    sysmod = spec.load_system(config["system"])
    return sysmod, sysmod.Built(pkg, config, world, traffic, "cpu")


def _leaves(x, out):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        for v in x:
            _leaves(v, out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _leaves(v, out)
    else:
        out.append(x)
    return out


def test_the_configuration_is_the_session_demos():
    """``session1.json``'s settings are ``NavigationConfig()`` at the widths
    ``entry.session_config()`` gives it."""
    config = spec.load_config("session1")
    got = spec.build_dataclass(NavigationConfig(), config["navigation"])
    assert got == entry.session_config()
    assert got.global_planner.max_long_edges == 4096
    assert got.global_planner.los_samples == 32
    assert got.global_planner.max_lethal_points == 2048


def test_the_state_is_one_tree_of_tensors_and_scalars(cell):
    sysmod, built = _side(cell, PROGRAM)
    state = built.state0
    for t in range(3):
        state, _ = sysmod.tick(built, state, t)
    leaves = _leaves(state, [])
    assert leaves and all(
        x is None or isinstance(x, (torch.Tensor, bool, int, float))
        for x in leaves), {type(x) for x in leaves}
    assert state.driver.plan_manager.dwa.global_path is not None


def test_step_twice_from_one_state_gives_the_same_state_and_answer(cell):
    sysmod, built = _side(cell, PROGRAM)
    state = built.state0
    for t in range(4):
        first = sysmod.tick(built, state, t)
        assert diff(first, sysmod.tick(built, state, t)) == 0.0, t
        state = first[0]


def test_step_leaves_the_state_it_was_given_as_it_was(cell):
    sysmod, built = _side(cell, PROGRAM)
    state = built.state0
    for t in range(4):
        before = to_side(state, PROGRAM)
        new, _ = sysmod.tick(built, state, t)
        assert diff(before, state) == 0.0, t
        assert len(_leaves(before, [])) == len(_leaves(state, []))
        state = new


def test_step_from_a_checkpoint_equals_tick_on_the_object(cell):
    """Each tick, the session's checkpoint (``state()``) stepped by a
    second session equals the first session's ``tick()``: the answer and
    the state after it, through a goal change and the rotate recovery."""
    _, _, tr = cell
    sysmod, a = _side(cell, PROGRAM)
    _, b = _side(cell, PROGRAM)
    sess = a.session
    goals, recovering = set(), 0
    for t in range(TICKS):
        p = t % tr.period
        x = sysmod.inputs(b, t)
        new, out = b.session.step(sess.state(), x)
        if x.goal is not None:
            sess.set_goal(x.goal, now=x.now)
            goals.add(tuple(x.goal.tolist()))
        for c, frame in enumerate(x.depth_frames):
            sess.push_depth_observation(c, *frame, x.now)
        got = sess.tick(tr.scans[p], tr.masks[p], tr.pos[p], tr.quat[p],
                        float(tr.v[p]), float(tr.w[p]), x.now)
        assert got == (out.vx, out.wz, out.decision, out.done,
                       out.succeeded), t
        assert torch.equal(out.cmd, torch.tensor([[out.vx, out.wz]])), t
        assert diff(sess.state(), new) == 0.0, t
        recovering += sess.driver.recovery is not None
    assert len(goals) == 2 and recovering > 0


def test_the_port_follows_the_reference_copy(cell):
    """20 seeded ticks of the port's session and of ``navbench.reference``'s
    copy, each from its own start: every number the cell compares is
    within the cell's limit."""
    config, _, _ = cell
    sysmod, prog = _side(cell, PROGRAM)
    _, ref = _side(cell, REFERENCE)
    assert diff(prog.state0, ref.state0) <= config["limits"]["start"]
    sp, sr = prog.state0, ref.state0
    for t in range(TICKS):
        sp, rp = sysmod.tick(prog, sp, t)
        sr, rr = sysmod.tick(ref, sr, t)
        rp["state"], rr["state"] = sp, sr
        for name, group in config["compare"].items():
            assert reading(group, rp, rr) <= config["limits"][name], (t, name)
    assert np.isfinite(rp["cmd"].numpy()).all()


def test_a_stepped_tick_records_its_spans_and_counters(patient_cell):
    """With the recorder on, a stepped tick is a ``tick`` span whose stages
    begin with ``session.load`` and end with ``session.store``, the plan
    manager's stage holds the DWA recompute and the LOS gate, and the
    lethal, LOS and plan counters are kept."""
    from dddmr_navigation_tpu_torch.runtime import tracing
    sysmod, built = _side(patient_cell, PROGRAM)
    state = built.state0
    with tracing.recording() as got:
        before = tracing.counters()
        for t in range(6):
            state, _ = sysmod.tick(built, state, t)
        after = tracing.counters()
    roots = [i for i, s in enumerate(got) if s.parent == -1]
    assert [got[i].name for i in roots] == ["tick"] * 6
    for i in roots:
        kids = [s.name for s in got if s.parent == i]
        assert kids[0] == "session.load" and kids[-1] == "session.store"
        assert "plan manager" in kids and "depth" in kids
    nested = {got[s.parent].name + "/" + s.name for s in got
              if s.name in ("plan.los", "plan.dwa")}
    assert "plan manager/plan.dwa" in nested and "plan.dwa/plan.los" in nested
    grew = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert grew["lethal_seen"] >= grew["lethal_kept"] > 0
    # the cut's sparse passage gives the gate long edges, all under its cap
    assert grew["los_edges_seen"] == grew["los_edges_kept"] > 0
    assert grew["plan_queries"] > 0 and grew["dwa_recomputes"] > 0


def test_the_gate_and_the_relaxation_decide_the_cells_plans(monkeypatch):
    """In the cell's world (at its CPU cut and its own 160-tick period)
    the LOS gate blocks long edges of the sparse passage and so moves an
    adopted plan: with a gate that passes every edge, some tick's plan
    differs. Each tick's diag counts the iterations its relaxations
    ran."""
    cell = _cell(160)
    from dddmr_navigation_tpu_torch.planning.global_ import planner
    real = planner.long_edge_los_mask
    blocked, plans, iters = [], {}, []

    def counting(*args, **kwargs):
        mask = real(*args, **kwargs)
        blocked.append(int((~mask).sum()))
        return mask

    def passing(*args, **kwargs):
        return torch.ones_like(real(*args, **kwargs))

    for name, gate in (("gate", counting), ("open", passing)):
        monkeypatch.setattr(planner, "long_edge_los_mask", gate)
        sysmod, built = _side(cell, PROGRAM)
        state, plans[name] = built.state0, []
        for t in range(40):
            state, rec = sysmod.tick(built, state, t)
            plans[name].append(state.driver.plan)
            if name == "gate":
                iters.append(int(rec["out"].diag["relax_iters"]))
    assert max(blocked) > 0
    assert any(diff(p, q) > 0 for p, q in zip(plans["gate"], plans["open"]))
    assert min(iters) >= 0 and sum(i > 0 for i in iters) > 10
