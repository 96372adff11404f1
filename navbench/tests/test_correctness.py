"""The comparison that decides ``correct``: the program with its float
operations reordered comes out correct, the bfloat16 control and every
planted fault do not."""
from __future__ import annotations

import pytest
import torch

from conftest import answer_shift, repeat_gap, tiny_cell
from navbench import calibrate
from navbench.run import PROGRAM, REFERENCE, run_cell, to_side
from navbench.spec import load_benchmark, load_generator, load_system
from navbench.world import build_world

WORKLOADS = [w["name"] for w in load_benchmark()["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reordered_program_is_correct(workload):
    """PyTorch's own ops in place of the program's reproductions of XLA's
    rounding move the floats by some ulps: the limits leave room for it."""
    cell = tiny_cell(workload)
    with calibrate.plain_rounding(PROGRAM, cell.config) as swapped:
        out = run_cell(cell, 2 ** 31 + 2, 0.3, False, "cpu")
    assert swapped > 20
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_bfloat16_control_is_not_correct(workload):
    cell = tiny_cell(workload)
    out = run_cell(cell, 2 ** 31 + 3, 0.3, False, "cpu", program=REFERENCE,
                   program_context=calibrate.lower_precision(REFERENCE,
                                                             cell.config))
    assert not out["correct"]
    assert out["checks"]["start"]["value"] > 0     # its start state too


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in WORKLOADS for f in calibrate.FAULTS])
def test_each_planted_fault_is_not_correct(workload, fault):
    cell = tiny_cell(workload)
    if not calibrate.applicable(fault, cell.config):
        assert cell.config["robots"] == 1      # no half of one robot
        return
    out = run_cell(cell, 2 ** 31 + 4, 0.3, False, "cpu",
                   program_context=calibrate.fault(fault, cell.config))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_tick_leaves_the_state_it_was_given_as_it_was(workload):
    """The run keeps the program's state from before each compared tick by
    reference, not by a copy: the tick must not write into it."""
    cell = tiny_cell(workload)
    world = build_world(cell.config["map"])
    traffic = load_generator(cell.traffic["generator"])(
        world, cell.config, cell.traffic, 9, "cpu")
    sysmod = load_system(cell.config["system"])
    built = sysmod.Built(PROGRAM, cell.config, world, traffic, "cpu")
    state = built.state0
    for t in range(3):
        before = to_side(state, PROGRAM)
        new, _ = sysmod.tick(built, state, t)
        flat_a, flat_b = [], []
        calibrate._map_tree(flat_a.append, before)
        calibrate._map_tree(flat_b.append, state)
        assert all(torch.equal(a, b) for a, b in zip(flat_a, flat_b))
        state = new


def _built(workload):
    cell = tiny_cell(workload)
    world = build_world(cell.config["map"])
    traffic = load_generator(cell.traffic["generator"])(
        world, cell.config, cell.traffic, 10, "cpu")
    sysmod = load_system(cell.config["system"])
    return cell, sysmod, sysmod.Built(PROGRAM, cell.config, world, traffic,
                                      "cpu")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_state_tree_carries_all_of_the_programs_state(workload):
    """The faults are planted in the system's tick and the forced ticks
    start from the program's state tree: a tick called twice from one
    state gives the same state and record, nothing kept in ``Built``."""
    _, sysmod, built = _built(workload)
    assert repeat_gap(sysmod, built) == 0.0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_record_carries_the_answer_of_the_programs_entry(workload):
    """The altered answer is planted in the record: the record's answer
    has to be the one that the program's entry returned."""
    cell, sysmod, built = _built(workload)
    assert answer_shift(sysmod, built, cell.config) == pytest.approx(
        1e-3, rel=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_tiny_run_on_the_card_is_correct(workload, cuda_device):
    out = run_cell(tiny_cell(workload), 2 ** 31 + 8, 1.0, True, cuda_device)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
