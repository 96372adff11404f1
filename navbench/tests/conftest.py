"""Cells cut to a CPU test's size: the same files, smaller numbers.

Each configuration's cut is ``tiny/<config>.json``, merged over the
configuration; its ``traffic``, if any, is merged over :data:`TINY_TRAFFIC`,
which is merged over the cell's traffic. The tests here run on the CPU
(the kernels take their plain versions there); those that need the card
carry the ``cuda`` marker and decide in a fixture whether there is one.
"""
from __future__ import annotations

import copy
import json
import os

import pytest
import torch

from navbench import spec
from navbench.calibrate import _map_tree
from navbench.run import PROGRAM, diff, resolve_path
from navbench.trace import patched

TINY_TRAFFIC = {"period_ticks": 48, "warmup_ticks": 1,
                "check": {"chain_ticks": 2, "forced_ticks": 2, "below": 6},
                "trace": {"profile_ticks": 1, "sync_ticks": 1}}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else copy.deepcopy(v))
    return out


def cpu_cut_path(config: str) -> str:
    return os.path.join(spec.HERE, "tiny", f"{config}.json")


def tiny_cell(workload: str, bench: dict = None) -> spec.Cell:
    """The cell ``workload`` of ``bench`` (the benchmark's own by default)
    cut to a CPU test's size."""
    torch.set_num_threads(2)
    cell = spec.Cell(bench or spec.load_benchmark(), workload)
    with open(cpu_cut_path(cell.entry["config"])) as f:
        cut = json.load(f)
    traffic = _merge(TINY_TRAFFIC, cut.pop("traffic", {}))
    cell.config = _merge(cell.config, cut)
    cell.traffic = _merge(cell.traffic, traffic)
    return cell


def repeat_gap(sysmod, built, ticks: int = 3) -> float:
    """How far a second call of each of the first ``ticks`` ticks, from
    the same state, lands from the first (state and record): 0 where the
    state tree carries all of the program's state, as the planted faults
    and the forced ticks need."""
    state, gap = built.state0, 0.0
    for t in range(ticks):
        first = sysmod.tick(built, state, t)
        gap = max(gap, diff(first, sysmod.tick(built, state, t)))
        state = first[0]
    return gap


def answer_shift(sysmod, built, config: dict) -> float:
    """How far the first path of ``compare["cmd"]`` in tick 0's record
    moves when the program's entry returns every float 1e-3 off: 1e-3
    where the record's answer is the one the entry returned."""
    def make(_name, fn):
        def off(*args, **kwargs):
            return _map_tree(lambda x: x + 1e-3 if x.is_floating_point()
                             else x, fn(*args, **kwargs))
        return off
    cmd = config["compare"]["cmd"]
    path = (cmd["paths"] if isinstance(cmd, dict) else cmd)[0]
    _, rec = sysmod.tick(built, built.state0, 0)
    with patched(PROGRAM, {"entry": config["entry"]}, make):
        _, moved = sysmod.tick(built, built.state0, 0)
    return diff(resolve_path(moved, path), resolve_path(rec, path))


@pytest.fixture
def cuda_device():
    """The card, or a skip when there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
