"""One run of a ``navbench`` cell with the port's span and counter recorder
on (``dddmr_navigation_tpu_torch/runtime/tracing.py``), read into per-layer
numbers: the layers' times a tick from the spans, host reads a tick, the
mark/clear graph's (and the fleet's localize graph's) captures and
replays a tick and captures over every tick, the successor-table walk
kernel's launches a tick (``walk.kernel``: one an extraction), the share
of marked cells past the cap, the cold first tick, and, with
``--trace 1``, the profiled ticks' device-idle time, kernel launches and
CUDA sync-debug warnings by the innermost span open at each.

    python3 tools/span_report.py --workload fleet64-crowded --seed 7 \\
        --seconds 51 --trace 1 --out spans.json

The run is the harness's own (``navbench.run.run_cell``), with the
recorder turned on before the program's set-up, so the cold tick is
recorded. With ``--trace 1`` three things of the harness are wrapped in
this process only: the profile is kept for the joins below, the sync
count names the span each sync fired in, and the profiler's ``span:``
ranges are left off the device row as the harness's own ranges are. The
recorder's clock is mapped onto the profile's by
``tracing.clock_offset_ns``. A run with the recorder off is the
harness's own, ``python3 -m navbench.run``. Needs a CUDA device; the
result is one JSON object on stdout (and in ``--out``), the tables on
stderr.

A stopgap: these numbers belong in the benchmark's own readers
(``navbench/run.py`` and ``readers.py``), and the tool goes when they
take its arithmetic.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse            # noqa: E402
import bisect              # noqa: E402
import json                # noqa: E402
import os                  # noqa: E402
import re                  # noqa: E402
import sys                 # noqa: E402
import warnings            # noqa: E402


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the harness's stage metrics and the spans whose boundaries match theirs
AGREE = {
    "fleet": {"fleet.localize_ms": ["localize"],
              "fleet.perceive_ms": ["perceive.mark_clear", "perceive.compose",
                                    "plan.prepare"],
              "fleet.plan_ms": ["plan.relax", "plan.extract",
                                "plan.interpolate"],
              "fleet.local_ms": ["local"],
              "fleet.decide_ms": ["decide"]},
    "fused": {"fused.perceive_ms": ["perceive.mark_clear", "perceive.compose",
                                    "plan.prepare"],
              "fused.plan_ms": ["plan.relax", "plan.extract"],
              "fused.local_ms": ["plan.interpolate", "local"]},
    "session": {"session.perceive_ms": ["perception"],
                "session.depth_ms": ["depth"],
                "session.compose_ms": ["composition+lethal"],
                "session.plan_ms": ["plan manager"],
                "session.local_ms": ["local tick"],
                "session.fsm_ms": ["FSM"]},
}
PERCEIVE = ["perceive.mark_clear", "perceive.compose"]
PLAN = ["plan.prepare", "plan.relax", "plan.extract", "plan.interpolate"]
# the session tick's stage spans, by the name of its stage metric
SESSION = {"perceive_ms": ["perception"], "depth_ms": ["depth"],
           "compose_ms": ["composition+lethal"], "plan_ms": ["plan manager"],
           "local_ms": ["local tick"], "fsm_ms": ["FSM"],
           "load_ms": ["session.load"], "store_ms": ["session.store"]}


def layer_ms(kept, roots, names) -> float | None:
    """Mean ms a tick of the spans named ``names`` inside the root spans
    ``roots`` (indices into ``kept``)."""
    if not roots:
        return None
    idx = set(roots)
    tot = {}
    for s in kept:
        if s.parent in idx and s.name in names and s.end_ns is not None:
            tot[s.parent] = tot.get(s.parent, 0) + s.end_ns - s.start_ns
    if not tot:
        return None
    return sum(tot.values()) * 1e-6 / len(roots)


def nested_ms(kept, roots, name) -> float | None:
    """Mean ms a tick of the spans named ``name`` at any depth inside the
    root spans ``roots``."""
    if not roots:
        return None
    ticks = {kept[i].tick for i in roots}
    ns = sum(s.end_ns - s.start_ns for s in kept if s.tick in ticks
             and s.name == name and s.parent >= 0 and s.end_ns is not None)
    return ns * 1e-6 / len(roots)


def span_metrics(kind, kept, roots, window, counters) -> dict:
    """The per-layer numbers of one run: ``window`` are the root indices of
    the measured ticks, ``roots`` of every tick."""
    out = {}
    layers = {"perceive_ms": PERCEIVE, "plan_ms": PLAN,
              "plan_prepare_ms": ["plan.prepare"], "local_ms": ["local"]}
    if kind == "fleet":
        layers.update(localize_ms=["localize"], decide_ms=["decide"])
    if kind == "session":
        layers = SESSION
        for name in ("plan.los", "plan.dwa"):
            out[f"session.span.{name[5:]}_ms"] = nested_ms(kept, window, name)
        for what in ("lethal", "los_edges"):
            seen = counters.get(f"{what}_seen")
            if seen:
                out[f"session.{what}_dropped_pct"] = 100.0 * (
                    1.0 - counters[f"{what}_kept"] / seen)
    for key, names in layers.items():
        out[f"{kind}.span.{key}"] = layer_ms(kept, window, names)
    out[f"{kind}.host_reads_per_tick"] = reads_per_tick(kept, window)
    graphs = ("mark_clear", "localize") if kind == "fleet" else ("mark_clear",)
    for graph in graphs:
        for what in ("capture", "replay"):
            out[f"{kind}.{graph}_graph_{what}s_per_tick"] = reads_per_tick(
                kept, window, f"{graph}.graph_{what}")
        out[f"{kind}.{graph}_graph_captures"] = (reads_per_tick(
            kept, roots, f"{graph}.graph_capture") or 0.0) * len(roots)
    out[f"{kind}.walk_kernels_per_tick"] = reads_per_tick(kept, window,
                                                          "walk.kernel")
    if kind == "fleet" and counters.get("marked_cells"):
        out["fleet.marked_dropped_pct"] = 100.0 * (
            1.0 - counters["marked_kept"] / counters["marked_cells"])
    first = kept[roots[0]] if roots else None
    out[f"{kind}.cold_tick_s"] = ((first.end_ns - first.start_ns) * 1e-9
                                  if first else None)
    return out


def reads_per_tick(kept, roots, name="host_reads") -> float | None:
    """The host counter ``name`` a tick over the ticks of the root spans
    ``roots``."""
    if not roots:
        return None
    ticks = {kept[i].tick for i in roots}
    return sum(s.counts.get(name, 0) for s in kept
               if s.tick in ticks) / len(roots)


class _Innermost:
    """The innermost recorder span open at a time of the profile's clock
    (µs), over the spans opened under the profile."""

    def __init__(self, kept, offset_ns):
        self.iv = sorted(((s.start_ns + offset_ns) * 1e-3,
                          (s.end_ns + offset_ns) * 1e-3, s.name)
                         for s in kept if s.profiled and s.end_ns is not None)
        self.starts = [a for a, _, _ in self.iv]

    def at(self, t: float) -> str:
        j = bisect.bisect_right(self.starts, t)
        for a, b, name in reversed(self.iv[max(0, j - 64):j]):
            if b >= t:
                return name
        return "outside spans"


def attribution(prof, kept, dev_trace_cls) -> dict:
    """Idle time, launches and device time of the profiled ticks by the
    innermost span, joined on the recorder's clock mapped to the
    profile's."""
    from dddmr_navigation_tpu_torch.runtime import tracing
    events = prof.events()
    offset, worst = tracing.clock_offset_ns(events, kept)
    if offset is None:
        return {"error": "no span: event in the profile"}
    tr = dev_trace_cls(events)
    inner = _Innermost(kept, offset)

    def host_at(t):
        """The host op at ``t``, as the harness names it."""
        return tr._host_at(t).rsplit(" / ", 1)[1]
    w0, w1 = tr.window
    gaps = list(tr.gaps)
    if tr.kernels:
        gaps = ([(w0, min(s for _, s, _ in tr.kernels))] + gaps
                + [(max(t for _, _, t in tr.kernels), w1)])
    idle_span, idle_op = {}, {}
    for s, e in gaps:
        if e > s:
            mid = 0.5 * (s + e)
            name = inner.at(mid)
            key = f"{name} / {host_at(mid)}"
            idle_span[name] = idle_span.get(name, 0.0) + (e - s) * 1e-6
            idle_op[key] = idle_op.get(key, 0.0) + (e - s) * 1e-6
    launches = {}
    n_launch = 0
    for e in events:
        if ("LaunchKernel" in e.name
                and e.device_type.name == "CPU"
                and w0 <= e.time_range.start <= w1):
            n = inner.at(e.time_range.start)
            launches[n] = launches.get(n, 0) + 1
            n_launch += 1
    busy = {}
    for name, s, e in tr.kernels:
        n = inner.at(s)
        busy[n] = busy.get(n, 0.0) + (e - s) * 1e-6
    def top(d, n=20):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:n]]
    return {"offset_ns": offset, "worst_mapping_us": worst * 1e-3,
            "window_s": tr.window_us * 1e-6, "busy_s": tr.busy_us * 1e-6,
            "idle_by_span": top(idle_span), "idle_by_span_op": top(idle_op),
            "launches_by_span": top(launches, 40),
            "launch_events": n_launch, "kernels": len(tr.kernels),
            "busy_by_span": top(busy)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from navbench import run as nb_run
    from navbench import trace as nb_trace
    from navbench.spec import Cell, load_benchmark
    nb_run.set_cache_dirs()
    import torch
    from dddmr_navigation_tpu_torch.runtime import tracing

    cell = Cell(load_benchmark(os.path.join(ROOT, "BENCHMARK.json")),
                args.workload)
    kind = {"fleet_full": "fleet", "fused": "fused",
            "session": "session"}[cell.config["system"]]
    lines, kept_prof, syncs = [], {}, []

    def log(msg):
        lines.append(msg)
        print(msg, file=sys.stderr, flush=True)

    if args.trace:
        nb_trace.ANNOTATIONS = nb_trace.ANNOTATIONS + ("span:",)
        profiled = nb_trace.profiled

        def keep_profile(run):
            out, prof = profiled(run)
            kept_prof["prof"] = prof
            return out, prof

        def sync_sites(fn):
            torch.cuda.synchronize()
            with warnings.catch_warnings():
                warnings.simplefilter("always")

                def show(message, category, filename, lineno, file=None,
                         line=None):
                    if "synchroniz" in str(message):
                        syncs.append((tracing.current() or "outside spans",
                                      f"{os.path.relpath(filename, ROOT)}:"
                                      f"{lineno}"))
                warnings.showwarning = show
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = fn()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            return len(syncs), out
        nb_trace.profiled = keep_profile
        nb_trace.sync_count = sync_sites
    tracing.reset()
    tracing.enable()
    out = nb_run.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", t0=T0, log=log)
    tracing.disable()
    kept = tracing.spans()
    counters = tracing.counters()
    roots = [i for i, s in enumerate(kept) if s.parent < 0
             and s.name == "tick"]
    warm = cell.traffic["warmup_ticks"]
    window = roots[warm:warm + out["attempted"]]
    rep = {"workload": args.workload, "seed": args.seed,
           "trace": args.trace, "correct": out["correct"],
           "failed": out["failed"], "attempted": out["attempted"],
           "metrics": out["metrics"],
           "device": out["device"], "ticks_recorded": len(roots),
           "counters": counters}
    for line in lines:
        m = re.match(r"ticks (\d+): p5/p25/p50/p75/p95/p99/max (\S+) ms",
                     line)
        if m:
            rep["tick_ms_p5_p25_p50_p75_p95_p99_max"] = [
                float(x) for x in m.group(2).split("/")]
        if line.startswith(("set-up", "fill ")):
            rep.setdefault("log", []).append(line)
    rep["span_metrics"] = span_metrics(kind, kept, roots, window, counters)
    names = sorted({s.name for s in kept if s.parent >= 0})
    rep["span_ms"] = {n: layer_ms(kept, window, [n]) for n in names}
    ticks = sorted((kept[i].end_ns - kept[i].start_ns) * 1e-6
                   for i in window)
    rep["tick_span_ms_p50"] = ticks[len(ticks) // 2] if ticks else None
    if counters.get("marked_cells"):
        cap = cell.config["report"]["marked_cells"][1]
        rep["run_marked_fill_pct"] = 100.0 * counters["marked_cells"] / (
            len(roots) * cell.config["robots"] * cap)
    if args.trace:
        rep["agreement"] = {}
        for metric, names in AGREE[kind].items():
            harness = out["metrics"].get(metric, {}).get("value")
            mine = layer_ms(kept, window, names)
            rep["agreement"][metric] = {
                "harness_ms": harness, "spans_ms": mine,
                "spans_over_harness": (mine / harness if harness and mine
                                       else None)}
        by = {}
        for name, site in syncs:
            by[f"{name} @ {site}"] = by.get(f"{name} @ {site}", 0) + 1
        rep["syncs_by_span_site"] = sorted(
            [[k, v] for k, v in by.items()], key=lambda kv: -kv[1])
        sync_ticks = cell.traffic["trace"]["sync_ticks"]
        prof_ticks = cell.traffic["trace"]["profile_ticks"]
        tail = roots[len(roots) - prof_ticks - sync_ticks:
                     len(roots) - prof_ticks]
        rep["sync_ticks_host_reads_per_tick"] = reads_per_tick(kept,
                                                               tail)
        if "prof" in kept_prof:
            rep["attribution"] = attribution(kept_prof["prof"], kept,
                                             nb_trace.DeviceTrace)
            rep["attribution"]["profiled_ticks"] = prof_ticks
    text = json.dumps(rep)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
