"""The port's navigation session at the session scenario's full width
(``entry.session_scenario()``) against the JAX session's golden file
(``tools/make_session_golden.py``), on the CPU: the first ticks from the
recorded inputs, and ticks 96-99 each restored from the recorded state
through ``interop.port_session_state`` (tick 98 once moved a voxel when the
range image's column constant was not folded as XLA folds it). Exact for
decisions, planner states, plan counts, done, succeeded and DWA pivots;
1e-5 for commands and the composed field (the chip check's tolerance; the
CPU replay is in fact exact)."""
import os

import numpy as np
import pytest
import torch

from dddmr_navigation_tpu_torch import entry

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dddmr_navigation_tpu_torch", "testdata",
    "session_golden.npz")


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    return entry.session_scenario(), {k: g[k] for k in g.files}


def check(g, out, first=0):
    bad, dv, dw, dc = entry.replay_errors(g, out, first)
    assert not bad, bad
    assert max(dv, dw, dc) <= 1e-5, (dv, dw, dc)


def test_golden_records_a_successful_chain(golden):
    sc, g = golden
    assert bool(g["succeeded"][-1]) and bool(g["done"][-1])
    assert int(g["replay_ticks"]) == len(g["vx"]) <= entry.SESSION_TICKS
    pos = g["pos"]
    assert np.linalg.norm(pos[-1, :2] - sc.goal[:2]) < 0.6
    assert pos[:, 1].min() < -1.5          # the detour on the -y side


def test_first_ticks_replay_at_full_width(golden):
    sc, g = golden
    out = entry.replay_session(entry.make_session(sc, "cpu"), sc, g,
                               ticks=4)
    check(g, out)
    assert [o["decision"] for o in out][:3] == [1, 2, 3]


def test_forced_ticks_from_the_recorded_state(golden):
    """Ticks 96-99 of the chain, each started from the JAX session's
    recorded state; the first restore carries the whole host state (the
    adopted plan, the DWA cache, the timers) into a fresh session."""
    sc, g = golden
    out = entry.replay_session(entry.make_session(sc, "cpu"), sc, g,
                               forced=True, ticks=4, first=96)
    check(g, out, first=96)
    # the 10 Hz recompute timer skips ticks whose clock difference rounds
    # below 0.1 s, in JAX's chain too
    assert any(o["pivot"] >= 0 for o in out)
