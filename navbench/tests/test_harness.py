"""The harness's plumbing: files found by name, the result line's keys,
new cells and configurations added by files alone, method targets, and
the traffic's determinism."""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

from conftest import answer_shift, cpu_cut_path, repeat_gap, tiny_cell
import navbench.systems
from navbench import calibrate, spec, trace
from navbench.run import PROGRAM, run_cell
from navbench.world import build_world

CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}
BENCH = spec.load_benchmark()
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_every_named_file_loads():
    for c in BENCH["configs"]:
        path = os.path.join(spec.ROOT, c["file"])
        assert spec.load_config(c["name"]) == json.load(open(path))
        assert spec.load_config(c["name"])["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        cell = spec.Cell(BENCH, w["name"])
        assert cell.traffic["period_ticks"] > 0
        assert callable(spec.load_generator(cell.traffic["generator"]))
        spec.load_system(cell.config["system"])
    for m in BENCH["per_layer"]:
        assert callable(spec.load_reader(m["name"]))


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_every_configuration_has_a_cpu_cut(config):
    path = cpu_cut_path(config)
    assert os.path.isfile(path), (
        f"configuration {config!r} has no CPU cut: add "
        f"{os.path.relpath(path, spec.ROOT)} (the keys of its file that "
        f"the tests shrink, and optionally a \"traffic\" cut)")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_tiny_run_is_correct_and_its_line_has_the_contract_keys(workload):
    out = run_cell(tiny_cell(workload), 2 ** 31 + 17, 0.5, False, "cpu")
    assert set(out) == CONTRACT_KEYS | {"checks"}
    assert list(out)[-1] == "checks"
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert set(out["metrics"]) == names
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}


def test_traced_tiny_run_reads_its_spans_and_counters():
    cell = tiny_cell("fleet64-crowded")
    out = run_cell(cell, 5, 0.5, True, "cpu")
    assert set(out) == CONTRACT_KEYS | {"checks"}
    got = set(out["metrics"])
    # on the CPU no device metric is read: no profile, no sync count
    assert {"fleet.localize_ms", "fleet.plan_ms", "fleet.relax_iters",
            "fleet.decide_ms"} <= got
    assert not any("roofline" in k or "idle" in k or "launches" in k
                   or "syncs" in k for k in got)
    assert out["correct"]


def test_a_method_target_is_timed_and_then_restored():
    from dddmr_navigation_tpu_torch.config import schema
    own = vars(schema.CuboidConfig)["corners"]
    timer = trace.StageTimer(cuda=False)
    target = {"corners": "config.schema:CuboidConfig.corners"}
    with trace.patched(PROGRAM, target, timer.wrap):
        assert vars(schema.CuboidConfig)["corners"] is not own
        timer.tick()
        got = schema.CuboidConfig().corners()
    assert got == own(schema.CuboidConfig())
    assert len(timer.times()["corners"]) == 1
    assert vars(schema.CuboidConfig)["corners"] is own

    # an inherited method: the wrapper goes again, the base keeps its own
    class Wider(schema.CuboidConfig):
        pass
    schema.Wider = Wider
    try:
        with trace.patched(PROGRAM, {"c": "config.schema:Wider.corners"},
                           timer.wrap):
            assert "corners" in vars(Wider)
        assert "corners" not in vars(Wider)
        assert vars(schema.CuboidConfig)["corners"] is own
    finally:
        del schema.Wider


# A configuration with a new name, made of files alone: its cut, a
# generator whose traffic has no ``clutter`` or ``speeds``, a stage that is
# a method, a system whose state is a tree of a dict over NamedTuples.
NEW_GENERATOR = '''\
from typing import NamedTuple

from navbench.generators import tours

FIELDS = [f for f in tours.Traffic._fields if f not in ("clutter", "speeds")]


class Bare(NamedTuple("Bare", [(f, object) for f in FIELDS])):
    @property
    def period(self):
        return self.pos.shape[0]


def generate(world, config, p, seed, device):
    t = tours.generate(world, config, p, seed, device)
    return Bare(*(getattr(t, f) for f in FIELDS))
'''
NEW_SYSTEM = '''\
import torch

from navbench.systems import fleet_full

MODULES = fleet_full.MODULES


class Built(fleet_full.Built):
    def __init__(self, pkg, config, world, traffic, device):
        super().__init__(pkg, config, world, traffic, device)
        self.state0 = {"fleet": self.state0,
                       "ticks": torch.zeros((), dtype=torch.int64)}


def tick(b, state, t):
    fleet, rec = fleet_full.tick(b, state["fleet"], t)
    return {"fleet": fleet, "ticks": state["ticks"] + 1}, rec
'''
# A system that breaks the contract: it keeps the fleet's state in
# ``Built`` and hands on a tree that holds none of it.
HELD_SYSTEM = '''\
import torch

from navbench.systems import fleet_full

MODULES = fleet_full.MODULES


class Built(fleet_full.Built):
    def __init__(self, pkg, config, world, traffic, device):
        super().__init__(pkg, config, world, traffic, device)
        self.held = self.state0
        self.state0 = {"ticks": torch.zeros((), dtype=torch.int64)}


def tick(b, state, t):
    b.held, rec = fleet_full.tick(b, b.held, t)
    return {"ticks": state["ticks"] + 1}, rec
'''
NEW_SYSTEMS = ("tree_fleet", "held_fleet")


def _new_configuration(root, monkeypatch) -> spec.Cell:
    """The benchmark with a cell of configuration ``tree64``, whose files
    lie under ``root`` with copies of the harness's own; its system
    modules lie in ``root/systems``, which ``navbench.systems`` searches
    first."""
    import shutil
    for d in ("configs", "traffic", "metrics", "generators", "tiny"):
        shutil.copytree(os.path.join(spec.HERE, d), root / d)
    (root / "systems").mkdir()
    conf = spec.load_config("fleet64")
    conf.update(name="tree64", system="tree_fleet")
    conf["stages"] = {**conf["stages"],
                      "fov": "perception.marking:MarkingParams.fov"}

    def nested(path):
        return "state.fleet." + path[6:] if path.startswith("state.") \
            else path
    conf["compare"] = {
        g: ({**v, "paths": [nested(p) for p in v["paths"]]}
            if isinstance(v, dict) else [nested(p) for p in v])
        for g, v in conf["compare"].items()}
    conf["report"] = {k: [nested(p), cap]
                      for k, (p, cap) in conf["report"].items()}
    (root / "configs" / "tree64.json").write_text(json.dumps(conf))
    (root / "tiny" / "tree64.json").write_text(
        (root / "tiny" / "fleet64.json").read_text())
    (root / "generators" / "bare_tours.py").write_text(NEW_GENERATOR)
    (root / "systems" / "tree_fleet.py").write_text(NEW_SYSTEM)
    (root / "systems" / "held_fleet.py").write_text(HELD_SYSTEM)
    monkeypatch.setattr(navbench.systems, "__path__",
                        [str(root / "systems"), *navbench.systems.__path__])
    for name in NEW_SYSTEMS:            # another test's copy
        monkeypatch.delitem(sys.modules, f"navbench.systems.{name}",
                            raising=False)
    tr = spec.load_traffic("fleet64-open")
    tr["generator"] = "bare_tours"
    (root / "traffic" / "tree64-open.json").write_text(json.dumps(tr))
    (root / "metrics" / "tree.robots_seen.py").write_text(
        "def read(record):\n    return float(record['robots'])\n")
    (root / "metrics" / "tree.fov_ms.py").write_text(
        "from navbench import readers\n\n\n"
        "def read(record):\n"
        "    return readers.stage_ms(record, ['fov'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "tree64", "source": "x",
                             "file": "navbench/configs/tree64.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "throwaway", "config": "tree64",
                               "traffic": "tree64-open", "chips": 1,
                               "why": "a test"})
    for name in ("tree.robots_seen", "tree.fov_ms"):
        bench["per_layer"].append({
            "name": name, "unit": "x", "better": "higher",
            "source": "host_clock", "layer": "entry",
            "moves": "robot_ticks_per_s", "workloads": ["throwaway"]})
    monkeypatch.setattr(spec, "HERE", str(root))
    return tiny_cell("throwaway", bench)


def _program_side(cell):
    world = build_world(cell.config["map"])
    traffic = spec.load_generator(cell.traffic["generator"])(
        world, cell.config, cell.traffic, 15, "cpu")
    sysmod = spec.load_system(cell.config["system"])
    return sysmod, sysmod.Built(PROGRAM, cell.config, world, traffic, "cpu")


@pytest.mark.parametrize("check", ["contract", "traced", "reordered",
                                   "control", *calibrate.FAULTS,
                                   "state_tree", "answer"])
def test_a_new_cell_config_and_metric_are_files_and_entries(check, tmp_path,
                                                            monkeypatch):
    cell = _new_configuration(tmp_path / "navbench", monkeypatch)
    lines = []
    if check in ("state_tree", "answer"):
        sysmod, built = _program_side(cell)
        assert sysmod.__file__ == str(tmp_path / "navbench" / "systems"
                                      / "tree_fleet.py")
        if check == "state_tree":
            assert repeat_gap(sysmod, built) == 0.0
        else:
            assert answer_shift(sysmod, built, cell.config) == \
                pytest.approx(1e-3, rel=1e-3)
    elif check in ("contract", "traced"):
        out = run_cell(cell, 11, 0.3, check == "traced", "cpu",
                       log=lines.append)
        assert set(out) == CONTRACT_KEYS | {"checks"}
        assert any(line.startswith("traffic: pos (48, 3, 3)")
                   and "clutter" not in line for line in lines), lines
        assert out["correct"], out["checks"]
        if check == "traced":
            assert out["metrics"]["tree.robots_seen"]["value"] == 3.0
            assert out["metrics"]["tree.fov_ms"]["value"] > 0
            assert "fleet.relax_iters" not in out["metrics"]   # not listed
        else:
            assert set(out["metrics"]) == {m["name"]
                                           for m in BENCH["end_to_end"]}
    elif check == "reordered":
        with calibrate.plain_rounding(PROGRAM, cell.config) as swapped:
            out = run_cell(cell, 12, 0.3, False, "cpu")
        assert swapped > 20
        assert out["correct"], out["checks"]
    elif check == "control":
        from navbench.run import REFERENCE
        out = run_cell(cell, 13, 0.3, False, "cpu", program=REFERENCE,
                       program_context=calibrate.lower_precision(
                           REFERENCE, cell.config))
        assert not out["correct"]
        assert out["checks"]["start"]["value"] > 0
    else:
        out = run_cell(cell, 14, 0.3, False, "cpu",
                       program_context=calibrate.fault(check, cell.config))
        assert not out["correct"], out["checks"]
    from dddmr_navigation_tpu_torch.perception import marking
    assert vars(marking.MarkingParams)["fov"].__qualname__ == \
        "MarkingParams.fov"                     # the method put back


def test_a_system_that_keeps_its_state_in_built_is_caught(tmp_path,
                                                          monkeypatch):
    """A system whose tree leaves out the program's state: a fault planted
    in its tick would reach nothing of it, and the state-tree check
    reads it."""
    cell = _new_configuration(tmp_path / "navbench", monkeypatch)
    cell.config["system"] = "held_fleet"
    sysmod, built = _program_side(cell)
    assert repeat_gap(sysmod, built) > 0


def _tensors(traffic) -> dict:
    """Every tensor and array of a generator's traffic, by its field and
    place."""
    out = {}

    def walk(prefix, x):
        if isinstance(x, (torch.Tensor, np.ndarray)):
            out[prefix] = torch.as_tensor(x)
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(f"{prefix}.{k}", v)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f"{prefix}.{i}", v)
    for field, value in traffic._asdict().items():
        walk(field, value)
    return out


@pytest.mark.parametrize("workload", WORKLOADS)
def test_traffic_is_deterministic_in_the_seed(workload):
    cell = tiny_cell(workload)
    world = build_world(cell.config["map"])
    generate = spec.load_generator(cell.traffic["generator"])
    a = generate(world, cell.config, cell.traffic, 2 ** 31 + 5, "cpu")
    b = generate(world, cell.config, cell.traffic, 2 ** 31 + 5, "cpu")
    c = generate(world, cell.config, cell.traffic, 2 ** 31 + 6, "cpu")
    flat_a, flat_b, flat_c = _tensors(a), _tensors(b), _tensors(c)
    assert flat_a and list(flat_a) == list(flat_b) == list(flat_c)
    for field in flat_a:
        assert torch.equal(flat_a[field], flat_b[field]), field
    assert any(not torch.equal(flat_a[f], flat_c[f]) for f in flat_a)
    if cell.traffic["generator"] == "tours":
        assert not torch.equal(a.pos, c.pos)     # the seed moves the tours
        # tours close on themselves: the last tick leads back to the first
        step = (a.pos[0] - a.pos[-1]).norm(dim=-1)
        assert (float(step.max())
                <= float(a.v.max()) * cell.config["dt"] * 1.01)
        assert int(a.masks.sum()) > 0


def test_main_refuses_without_the_card(capsys):
    from navbench.run import main
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert main(["--workload", "fleet64-crowded", "--seed", "1",
                 "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
