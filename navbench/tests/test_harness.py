"""The harness's plumbing: files found by name, the result line's keys,
new cells added by files alone, and the traffic's determinism."""
from __future__ import annotations

import json
import os
import shutil

import pytest
import torch

from conftest import tiny_cell
from navbench import spec
from navbench.run import run_cell
from navbench.generators.tours import generate
from navbench.world import build_world

CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}
BENCH = spec.load_benchmark()


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


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
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


def test_a_new_cell_config_and_metric_are_files_and_entries(tmp_path,
                                                             monkeypatch):
    root = tmp_path / "navbench"
    for d in ("configs", "traffic", "metrics", "generators"):
        shutil.copytree(os.path.join(spec.HERE, d), root / d)
    conf = spec.load_config("fleet64")
    conf["name"] = "fleet64-copy"
    (root / "configs" / "fleet64-copy.json").write_text(json.dumps(conf))
    tr = spec.load_traffic("fleet64-crowded")
    tr["clutter"]["count"] = 4
    tr["generator"] = "tours_bare"
    (root / "generators" / "tours_bare.py").write_text(
        "from navbench.generators import tours\n\n\n"
        "def generate(world, config, p, seed, device):\n"
        "    p = {**p, 'clutter': {**p['clutter'], 'count': 0}}\n"
        "    return tours.generate(world, config, p, seed, device)\n")
    (root / "traffic" / "fleet64-sparse.json").write_text(json.dumps(tr))
    (root / "metrics" / "fleet.robots_seen.py").write_text(
        "def read(record):\n    return float(record['robots'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "fleet64-copy", "source": "x",
                             "file": "navbench/configs/fleet64-copy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "throwaway", "config": "fleet64-copy",
                               "traffic": "fleet64-sparse", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "fleet.robots_seen", "unit": "robots",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "robot_ticks_per_s",
                               "workloads": ["throwaway"]})
    monkeypatch.setattr(spec, "HERE", str(root))
    cell = spec.Cell(bench, "throwaway")
    from conftest import TINY, TINY_TRAFFIC, _merge
    cell.config = _merge(cell.config, TINY["fleet64"])
    cell.traffic = _merge(cell.traffic, TINY_TRAFFIC)
    assert cell.traffic["clutter"]["count"] == 4
    lines = []
    out = run_cell(cell, 11, 0.3, True, "cpu", log=lines.append)
    assert any(line.startswith("traffic: 0 clutter boxes") for line in lines)
    assert out["metrics"]["fleet.robots_seen"]["value"] == 3.0
    assert out["correct"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_traffic_is_deterministic_in_the_seed(workload):
    cell = tiny_cell(workload)
    world = build_world(cell.config["map"])
    a = generate(world, cell.config, cell.traffic, 2 ** 31 + 5, "cpu")
    b = generate(world, cell.config, cell.traffic, 2 ** 31 + 5, "cpu")
    c = generate(world, cell.config, cell.traffic, 2 ** 31 + 6, "cpu")
    for field in ("pos", "quat", "v", "w", "goals", "scans", "masks",
                  "drift_pos", "drift_yaw"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    assert not torch.equal(a.pos, c.pos)
    assert all(torch.equal(a.draws[k], b.draws[k]) for k in a.draws)
    # tours close on themselves: the last tick leads back to the first
    step = (a.pos[0] - a.pos[-1]).norm(dim=-1)
    assert float(step.max()) <= float(a.v.max()) * cell.config["dt"] * 1.01
    assert int(a.masks.sum()) > 0


def test_main_refuses_without_the_card(capsys):
    from navbench.run import main
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert main(["--workload", "fleet64-crowded", "--seed", "1",
                 "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
