"""The mark/clear step at a benchmark cell's full size on the card: its
CUDA graph against its eager body on the cell's own ticks, the graph's
captures and replays a tick, and where a call's time goes.

    python3 tools/mark_clear_graph.py --workload robot8k-clutter --seed 7 \\
        --ticks 40 --reps 30 --out chiprun_out/mark_clear.json

The cell's world, traffic and program are built as ``navbench.run``
builds them, and ``--ticks`` ticks run closed loop from its start state,
each call of ``perception_update`` kept with its arguments and result.
Then:

* every kept call's result against ``_perception_step`` (the eager body)
  on the same arguments, bit for bit;
* captures and replays a tick over the ticks after the cell's warm-up;
* the last call timed ``--reps`` times in turns (eager, graph, graph,
  eager): the host's time to issue it (perf_counter, no sync inside) and
  its time to the end of its device work (CUDA events), for the eager
  body, the whole graphed call, and the graphed call's parts: the copies
  into the graph's input buffers, the replay, and the clones of its
  outputs;
* the allocator's peaks, allocated and reserved (a graph's pool is
  reserved, not allocated, between its replays).

Needs a CUDA device; prints one JSON object on stdout (and in ``--out``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def timed(torch, fn, reps):
    """(host ms to issue, ms to the end of the device work) of ``fn``,
    medians over ``reps`` calls."""
    import numpy as np
    host, device = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        a = time.perf_counter()
        fn()
        host.append((time.perf_counter() - a) * 1e3)
        e1.record()
        torch.cuda.synchronize()
        device.append(e0.elapsed_time(e1))
    return float(np.median(host)), float(np.median(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from navbench import run as nb_run
    from navbench.spec import (Cell, load_benchmark, load_generator,
                               load_system)
    from navbench.trace import patched
    from navbench.world import build_world
    nb_run.set_cache_dirs()
    import torch
    from dddmr_navigation_tpu_torch.perception import marking

    cell = Cell(load_benchmark(os.path.join(ROOT, "BENCHMARK.json")),
                args.workload)
    config, tp = cell.config, cell.traffic
    sysmod = load_system(config["system"])
    world = build_world(config["map"])
    traffic = load_generator(tp["generator"])(world, config, tp, args.seed,
                                              "cuda")
    built = sysmod.Built(nb_run.PROGRAM, config, world, traffic, "cuda")
    calls = []
    graphs = marking.MARK_CLEAR_GRAPHS
    counts = []

    def keep(_name, fn):
        def kept(*a):
            out = fn(*a)
            calls.append((a, out))
            return out
        return kept

    state = built.state0
    with patched(nb_run.PROGRAM, {"pu": "control.fused:perception_update"},
                 keep):
        for t in range(args.ticks):
            counts.append((graphs.captures, graphs.replays))
            state, rec = sysmod.tick(built, state, t)
            rec["cmd"].cpu()
    counts.append((graphs.captures, graphs.replays))
    warm = tp["warmup_ticks"]
    window = args.ticks - warm
    rep = {"workload": args.workload, "seed": args.seed,
           "ticks": args.ticks, "calls": len(calls),
           "captures_in_warmup": counts[warm][0] - counts[0][0],
           "captures_per_tick": (counts[-1][0] - counts[warm][0]) / window,
           "replays_per_tick": (counts[-1][1] - counts[warm][1]) / window}

    fields = ("grid", "origin", "dgraph", "clear_offset")
    mismatch = []
    for t, (a, out) in enumerate(calls):
        spec, ri, params, st, ctx, *rest = a
        eager = marking._perception_step(spec, ri, params, ctx, *st, *rest)
        mismatch += [[t, f] for f, x, y in zip(fields, out, eager)
                     if not torch.equal(x, y)]
    rep["mismatch"] = mismatch

    spec, ri, params, st, ctx, *rest = calls[-1][0]
    tensors = (*st, *rest)
    key = next(reversed(graphs._graphs))
    got = graphs._graphs[key]

    def eager():
        marking._perception_step(spec, ri, params, ctx, *tensors)

    def graphed():
        marking.perception_update(spec, ri, params, st, ctx, *rest)

    def copy_in():
        for buf, x in zip(got.inputs, tensors):
            buf.copy_(x)

    def replay():
        got.graph.replay()

    def clones():
        tuple(x.clone() for x in got.outputs)
    parts = {"eager": eager, "graph_call": graphed, "copy_in": copy_in,
             "replay": replay, "clones": clones}
    for fn in parts.values():
        fn()
    res = {name: [] for name in parts}
    for order in (list(parts), list(reversed(parts)),
                  list(reversed(parts)), list(parts)):
        for name in order:
            res[name].append(timed(torch, parts[name], args.reps))
    rep["timing_ms"] = {
        name: {"host_issue": sorted(h for h, _ in v)[len(v) // 2],
               "to_device_end": sorted(d for _, d in v)[len(v) // 2],
               "turns": v}
        for name, v in res.items()}
    rep["launches"] = {"copy_in": len(got.inputs),
                       "clones": len(got.outputs)}
    rep["memory_bytes"] = {
        "max_allocated": torch.cuda.max_memory_allocated(),
        "max_reserved": torch.cuda.max_memory_reserved(),
        "reserved_after": torch.cuda.memory_reserved()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    rep["card"] = smi.stdout.strip()
    text = json.dumps(rep)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)
    return 1 if mismatch else 0


if __name__ == "__main__":
    sys.exit(main())
