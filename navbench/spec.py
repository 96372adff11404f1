"""Finds what a cell is made of, by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Nothing here knows a cell by name: a new configuration, traffic mix,
kind of traffic or deployment, or metric is new files and new entries,
each found by its name:

* ``configs/<config>.json``: the deployment (its map, sensor and robots,
  the program's settings) and what the harness reaches in the program,
  each ``"module:attr"`` under the package (``"module:Class.attr"`` for
  a method, set on the class): ``system`` (the module
  ``systems/<system>.py``), ``init`` (what makes the start state),
  ``entry`` (the tick), ``stages`` ({name: target} timed in a traced run
  and rounded in the control), ``capture`` (a stage whose outputs the
  comparison reads, optional), ``kernels`` ({name: target} whose
  arguments the rooflines of ``bounds.py`` take, optional), ``counters``
  ({name: record path} read each traced tick, optional), ``compare``
  ({number: record paths}, with a ``cmd`` whose first path is the
  answer that the planted fault alters) and ``limits`` ({number: limit},
  ``start`` too), ``report`` ({name: [record path, cap]}, optional);
* ``tiny/<config>.json``: the configuration cut to a CPU test's size
  (merged over the configuration; its ``traffic``, if any, over the
  tests' traffic cut);
* ``traffic/<mix>.json``: the parameters that ``generators/<generator>.py``
  reads, with ``period_ticks``, ``warmup_ticks``, ``check`` and
  ``trace``;
* ``generators/<generator>.py``: ``generate(world, config, params, seed,
  device)`` returning a NamedTuple of the inputs that the system reads;
* ``systems/<system>.py`` (the module ``navbench.systems.<system>``):
  ``MODULES`` (the modules of a side it calls), ``Built(pkg, config,
  world, traffic, device)`` with its ``state0`` (a tree of tensors), and
  ``tick(built, state, t) -> (state, record)``, the benchmark's contract
  with the program, where the faults are planted. The state tree carries
  all of the program's state: ``Built`` holds only what no tick changes,
  so a tick is a function of its arguments (the faults and the forced
  ticks rely on it; a test holds every system to it). The record's
  ``cmd`` holds the answer that the program's entry returned. The
  reference under ``reference/`` holds a copy of every module it calls;
* ``metrics/<metric>.py``: ``read(record)`` of a per-layer metric.
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
