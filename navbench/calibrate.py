"""The readings that the comparison's limits are set from (not part of a
benchmark run).

    python3 -m navbench.calibrate --workload <name> --seconds <s> \
        --seeds <a,b,...> [--control-seeds ...] [--fault-seeds ...] \
        [--reordered-seeds ...] --out <file.json>

In one process, for each seed: a run of the program as the benchmark
makes it (its ``checks`` are the sound readings); the program with its
float operations reordered (:func:`plain_rounding`: how far a sound
change to the order of the program's arithmetic moves each number); the
control, which is the plain reference put in the program's place and
computed in bfloat16 (its start state and every float32 tensor a stage
of the tick hands on rounded to bfloat16); and each fault the cell can
have, planted in the tick of the configuration's system module
(``systems/<system>.py::tick``, the benchmark's contract with the
program):

* ``stale_state``: the tick returns the state it was given;
* ``half_batch``: the second half of the robots get the first half's
  record and state (a fleet only);
* ``altered_answer``: element 0 of the first path of the configuration's
  ``compare["cmd"]`` is 1e-3 off (robot 0's linear command in both
  configurations of today).

Planted there, a fault reaches the program because a system keeps to its
contract (``navbench/systems/__init__.py``): the state tree carries all
of the program's state, and the record's answer is the one that the
program's entry returned. ``navbench/tests/`` holds every system to both.

Each run prints its readings; the file gets them all.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import sys
import time

import torch

from navbench.run import PROGRAM, REFERENCE, run_cell, set_cache_dirs
from navbench.spec import Cell, load_benchmark, load_system
from navbench.trace import patched


def _map_tree(fn, x):
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_map_tree(fn, v) for v in x))
    if isinstance(x, dict):
        return {k: _map_tree(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map_tree(fn, v) for v in x)
    return x


def to_bf16(x):
    """Every float32 tensor of ``x`` rounded to bfloat16."""
    return _map_tree(lambda t: t.bfloat16().float()
                     if t.dtype == torch.float32 else t, x)


def lower_precision(pkg: str, config: dict):
    """Context: ``pkg``'s start state and the stages of its tick hand on
    bfloat16 values."""
    def make(_name, fn):
        def rounded(*args, **kwargs):
            return to_bf16(fn(*args, **kwargs))
        return rounded
    return lambda: patched(pkg, {"init": config["init"],
                                 "entry": config["entry"],
                                 **config["stages"]}, make)


def _halves(x):
    def half(t):
        b = t.shape[0] if t.dim() else 0
        if b < 2:
            return t
        out = t.clone()
        out[b // 2:] = t[:b - b // 2]
        return out
    return _map_tree(half, x)


def _altered(x: torch.Tensor) -> torch.Tensor:
    y = x.flatten().clone()
    y[0] += 1e-3
    return y.reshape(x.shape)


def _replaced(x, path: list, fn):
    """A copy of the tree ``x`` with ``fn`` applied to the value at
    ``path`` (its parts as :func:`navbench.run.resolve_path` reads them)."""
    if not path:
        return fn(x)
    part, rest = path[0], path[1:]
    if isinstance(x, dict):
        return {**x, part: _replaced(x[part], rest, fn)}
    if part.isdigit():
        items = list(x)
        items[int(part)] = _replaced(items[int(part)], rest, fn)
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return x._replace(**{part: _replaced(getattr(x, part), rest, fn)})


def fault(name: str, config: dict):
    """Context: the fault ``name`` planted in the tick of the
    configuration's system module, ``tick(built, state, t) -> (state,
    record)``: the benchmark's own contract with the program. The
    altered answer is element 0 of the first path of ``compare["cmd"]``."""
    sysmod = load_system(config["system"])
    cmd = config["compare"]["cmd"]
    answer = (cmd["paths"] if isinstance(cmd, dict) else cmd)[0].split(".")

    def make(tick):
        def faulty(built, state, t):
            state2, rec = tick(built, state, t)
            if name == "stale_state":
                return state, rec
            if name == "half_batch":
                return _halves(state2), _halves(rec)
            if name == "altered_answer":
                return state2, _replaced(rec, answer, _altered)
            raise KeyError(name)
        return faulty

    @contextlib.contextmanager
    def planted():
        tick = sysmod.tick
        sysmod.tick = make(tick)
        try:
            yield
        finally:
            sysmod.tick = tick
    return planted


FAULTS = ("stale_state", "half_batch", "altered_answer")

# PyTorch's own ops in place of the program's reproductions of XLA's
# rounding on the CPU (``rounding.py``): the same results, rounded
# otherwise, as a change that reorders float operations would give.
PLAIN_ROUNDING = {
    "fma": lambda a, b, c: a * b + c,
    "fma_dot": lambda a, b: (a * b).sum(-1),
    "sqrt_rn": torch.sqrt,
    "fma_norm": lambda v: torch.linalg.vector_norm(v, dim=-1),
    "sum_rows_xla": lambda x: x.sum(0),
    "mean_rows_xla": lambda x: x.mean(0),
    "cumsum_xla": lambda x: torch.cumsum(x, -1),
    "exp_fma": torch.exp,
    "atan2_xla": torch.atan2,
    "acos_xla": torch.acos,
    "asin_xla": torch.asin,
}


@contextlib.contextmanager
def plain_rounding(pkg: str, config: dict):
    """Context: every module of ``pkg`` that the cell loads calls
    :data:`PLAIN_ROUNDING` where it called its ``rounding`` module's
    functions, in set-up and in the ticks alike. Yields the number of
    names swapped."""
    for m in load_system(config["system"]).MODULES:
        importlib.import_module(f"{pkg}.{m}")
    rounding = importlib.import_module(f"{pkg}.rounding")
    own = {n: getattr(rounding, n) for n in PLAIN_ROUNDING}
    swaps = []
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == pkg or name.startswith(pkg + ".")):
            continue
        for fn_name in PLAIN_ROUNDING:
            if getattr(mod, fn_name, None) is own[fn_name]:
                swaps.append((mod, fn_name))
    for mod, fn_name in swaps:
        setattr(mod, fn_name, PLAIN_ROUNDING[fn_name])
    try:
        yield len(swaps)
    finally:
        for mod, fn_name in swaps:
            setattr(mod, fn_name, own[fn_name])


def applicable(name: str, config: dict) -> bool:
    return name != "half_batch" or config["robots"] > 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--reordered-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    set_cache_dirs()
    cell = Cell(load_benchmark(), args.workload)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    runs = [("program", s, PROGRAM, None) for s in ints(args.seeds)]
    runs += [("control", s, REFERENCE,
              lower_precision(REFERENCE, cell.config))
             for s in ints(args.control_seeds)]
    runs += [("reordered", s, PROGRAM,
              lambda: plain_rounding(PROGRAM, cell.config))
             for s in ints(args.reordered_seeds)]
    runs += [(f, s, PROGRAM, fault(f, cell.config))
             for s in ints(args.fault_seeds) for f in FAULTS
             if applicable(f, cell.config)]
    results = []
    for kind, seed, pkg, ctx in runs:
        t0 = time.perf_counter()
        try:
            out = run_cell(cell, seed, args.seconds, False, "cuda",
                           program=pkg, program_context=ctx, t0=t0)
            row = {"kind": kind, "seed": seed, "correct": out["correct"],
                   "attempted": out["attempted"], "failed": out["failed"],
                   "checks": {k: v["value"] for k, v in
                              out["checks"].items()},
                   "metrics": {k: v["value"] for k, v in
                               out["metrics"].items()}}
        except Exception as exc:         # a run that crashes has failed
            row = {"kind": kind, "seed": seed, "correct": False,
                   "error": repr(exc)}
        results.append(row)
        print(json.dumps(row), flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
