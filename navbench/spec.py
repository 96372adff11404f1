"""Finds what a cell is made of, by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. A configuration is ``configs/<name>.json`` (the deployment: its map,
its sensor, the program's settings and the comparison's limits); a traffic
mix is ``traffic/<name>.json`` (the parameters that the module
``generators/<generator>.py`` it names reads); a per-layer metric is
``metrics/<name>.py`` with a ``read(record)`` function. A configuration's
``system`` names the module under ``systems/`` that runs it. Nothing
here knows a cell by name: a new cell, configuration, traffic mix or
metric is a new file and a new entry (and a new kind of traffic or of
deployment a new module beside the others).
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(path: str = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, f"{name}.json")
    with open(path) as f:
        return json.load(f)


def load_config(name: str) -> dict:
    return _load_json("configs", name)


def load_traffic(name: str) -> dict:
    return _load_json("traffic", name)


def _load_file(kind: str, name: str):
    """The module ``<kind>/<name>.py``, loaded by its path (names may hold
    dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"navbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load_file("metrics", name).read


def load_generator(name: str):
    """The ``generate`` function of ``generators/<name>.py``, which makes
    a kind of traffic."""
    return _load_file("generators", name).generate


def load_system(name: str):
    """The module ``systems/<name>.py`` that runs a kind of deployment."""
    return importlib.import_module(f"navbench.systems.{name}")


class Cell:
    """One workload of the benchmark with its configuration, traffic and
    the metrics it reports."""

    def __init__(self, bench: dict, workload: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = cells[workload]
        self.name = workload
        self.config = load_config(self.entry["config"])
        self.traffic = load_traffic(self.entry["traffic"])
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if workload in m.get("workloads", [workload])]
        self.per_layer = [m for m in bench["per_layer"]
                          if workload in m.get("workloads", [workload])]


def build_dataclass(default, overrides: dict):
    """``default`` (a dataclass instance) with ``overrides`` applied; a
    dict given for a field that holds a dataclass is applied to it in
    turn. An unknown key raises."""
    names = {f.name for f in dataclasses.fields(default)}
    changes = {}
    for key, value in overrides.items():
        if key not in names:
            raise KeyError(f"{type(default).__name__} has no field {key!r}")
        current = getattr(default, key)
        if isinstance(value, dict) and dataclasses.is_dataclass(current):
            value = build_dataclass(current, value)
        elif isinstance(value, list):
            value = tuple(value)
        changes[key] = value
    return dataclasses.replace(default, **changes)
