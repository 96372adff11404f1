"""The benchmark's runner: one cell, one seed, one run.

    python3 -m navbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed as ``setup_s``, from the process's start): the cell's world
and traffic from the seed, the program's map tables and start state, and
``warmup_ticks`` ticks. The window: a closed loop of the program's ticks,
each timed from its call to its commands' arrival on the host, for
``--seconds``. With ``--trace 1`` the window also records stage times,
a few more ticks after it are counted for host syncs and a few more
profiled, and the line carries the per-layer metrics instead of the
end-to-end ones. After
the window the plain reference recomputes the seed's sampled ticks and
every compared number is printed beside its limit.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse            # noqa: E402
import importlib           # noqa: E402
import json                # noqa: E402
import math                # noqa: E402
import os                  # noqa: E402
import sys                 # noqa: E402

import numpy as np         # noqa: E402

PROGRAM = "dddmr_navigation_tpu_torch"
REFERENCE = "navbench.reference"
FORBIDDEN = ("jax", "jaxlib", "flax", "dddmr_navigation_tpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".navbench_cache")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``
    (compared whole: the program's name begins with the JAX package's)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def set_cache_dirs():
    """Kernel caches at fixed paths inside the checkout (the program's
    nvcc library lands in its own ``_build/`` there)."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")


def resolve_path(rec, path: str):
    """The value at a dotted ``path`` (attributes, keys, tuple indices)."""
    x = rec
    for part in path.split("."):
        if isinstance(x, dict):
            x = x[part]
        elif part.isdigit():
            x = x[int(part)]
        else:
            x = getattr(x, part)
    return x


def diff(a, b) -> float:
    """How far ``a`` is from ``b``: the largest absolute difference of
    floats (equal infinities and NaNs at the same places are equal; a
    finite value against an infinite one is infinitely far), the count of
    unequal integers and booleans, the largest over a tree."""
    import torch
    if a is None or b is None:
        return 0.0 if a is None and b is None else math.inf
    if isinstance(a, torch.Tensor):
        if not isinstance(b, torch.Tensor) or a.shape != b.shape:
            return math.inf
        a, b = a.detach().cpu(), b.detach().cpu()
        if a.is_floating_point() or b.is_floating_point():
            a, b = a.double(), b.double()
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            d = torch.where(same, 0.0, (a - b).abs())
            d = torch.where(torch.isnan(d), math.inf, d)
            return float(d.max()) if d.numel() else 0.0
        return float((a != b).sum())
    if isinstance(a, dict):
        return max([diff(a[k], b.get(k)) for k in a] or [0.0])
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return math.inf
        return max([diff(x, y) for x, y in zip(a, b)] or [0.0])
    return 0.0 if a == b else math.inf


def share_counts(a, b, atol: float, rtol: float) -> tuple:
    """(elements on which ``a`` and ``b`` differ, elements set on either
    side) over a tree: a float differs by more than ``atol + rtol·|b|``
    (equal infinities and NaNs at the same places are equal), an integer
    or boolean differs at all; an element is set where it is not zero. A
    tree that does not match in shape differs everywhere."""
    import torch
    if a is None or b is None:
        return (0, 0) if a is None and b is None else (1, 1)
    if isinstance(a, torch.Tensor):
        if not isinstance(b, torch.Tensor) or a.shape != b.shape:
            n = max(a.numel(), 1)
            return n, n
        a, b = a.detach(), b.detach()
        if a.is_floating_point() or b.is_floating_point():
            a, b = a.double(), b.double()
            same = (a == b) | (torch.isnan(a) & torch.isnan(b))
            gap = torch.where(same, 0.0, (a - b).abs())
            off = ~same & ~(gap <= atol + rtol * b.abs())
        else:
            off = a != b
        return int(off.sum()), int(((a != 0) | (b != 0)).sum())
    if isinstance(a, dict):
        parts = [share_counts(a[k], b.get(k), atol, rtol) for k in a]
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return 1, 1
        parts = [share_counts(x, y, atol, rtol) for x, y in zip(a, b)]
    else:
        return (0, 1) if a == b else (1, 1)
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def reading(group, prog_rec, ref_rec) -> float:
    """One tick's number of a ``compare`` group: for a list of paths the
    largest :func:`diff` over them; for ``{"paths", "share_over": [atol,
    rtol]}`` the share of the elements set on either side that differ
    beyond that tolerance (:func:`share_counts`, summed over the paths)."""
    if isinstance(group, dict):
        atol, rtol = group["share_over"]
        off = total = 0
        for p in group["paths"]:
            o, t = share_counts(resolve_path(prog_rec, p),
                                resolve_path(ref_rec, p), atol, rtol)
            off, total = off + o, total + t
        return off / total if total else 0.0
    return max(diff(resolve_path(prog_rec, p), resolve_path(ref_rec, p))
               for p in group)


def to_side(x, pkg: str):
    """A copy of the state tree ``x`` in ``pkg``'s NamedTuple classes (the
    program's state handed to the reference)."""
    import torch
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        mod = type(x).__module__
        if mod.startswith(PROGRAM + "."):
            mod = pkg + mod[len(PROGRAM):]
        cls = getattr(importlib.import_module(mod), type(x).__name__)
        return cls(*(to_side(v, pkg) for v in x))
    if isinstance(x, dict):
        return {k: to_side(v, pkg) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_side(v, pkg) for v in x)
    if isinstance(x, torch.Tensor):
        return x.clone()
    return x


def describe(traffic) -> str:
    """The fields of a generator's traffic (a NamedTuple), whatever they
    are: an array's shape (and range, along one axis), a dict's keys, a
    sequence's length."""
    def one(x):
        if hasattr(x, "shape"):
            if x.ndim == 0:
                return f"{float(x):g}"
            if x.ndim == 1 and len(x):
                return (f"{tuple(x.shape)} {float(x.min()):.2f}-"
                        f"{float(x.max()):.2f}")
            return str(tuple(x.shape))
        if isinstance(x, dict):
            return "{" + " ".join(x) + "}"
        if isinstance(x, (list, tuple)):
            return f"[{len(x)}]"
        return repr(x)
    return ", ".join(f"{k} {one(v)}" for k, v in traffic._asdict().items())


def check_ticks(check: dict, seed: int) -> tuple:
    """(the ticks the reference follows from its own start, the further
    ticks it recomputes from the program's state): the second drawn from
    the seed below ``check["below"]``."""
    chain = tuple(range(check["chain_ticks"]))
    rng = np.random.default_rng([seed, 7])
    forced = rng.choice(np.arange(check["chain_ticks"], check["below"]),
                        size=check["forced_ticks"], replace=False)
    return chain, tuple(sorted(int(t) for t in forced))


class Side:
    """One side's system module, its built tables and the capture of a stage's
    outputs on the ticks that are compared."""

    def __init__(self, pkg, sysmod, config, world, traffic, device):
        self.pkg, self.sysmod = pkg, sysmod
        self.capture = config.get("capture")
        self.built = sysmod.Built(pkg, config, world, traffic, device)

    def tick(self, state, t: int, keep: bool):
        """Tick ``t``; with ``keep`` the record also holds the new state
        and the captured stage's outputs."""
        from navbench.trace import patched
        if not keep:
            return self.sysmod.tick(self.built, state, t)
        got = {}

        def grab(_name, fn):
            def rec(*args, **kwargs):
                got["capture"] = fn(*args, **kwargs)
                return got["capture"]
            return rec
        targets = {"capture": self.capture} if self.capture else {}
        with patched(self.pkg, targets, grab):
            state2, rec = self.sysmod.tick(self.built, state, t)
        rec.update(got, state=state2)
        return state2, rec


def _finite(cmd) -> bool:
    return bool(np.isfinite(cmd.numpy()).all())


class _Loop:
    """The program's closed loop of ticks from a start state: each tick
    timed from its call to its commands on the host; the records of the
    ticks in ``keep_at`` kept with the state each started from."""

    def __init__(self, prog: Side, keep_at: set):
        self.prog, self.keep_at = prog, keep_at
        self.state, self.t = prog.built.state0, 0
        self.kept, self.latencies = {}, []
        self.attempted = self.failed = 0

    def tick(self):
        """One tick. Returns its record; a tick that raises counts as
        failed and raises RuntimeError."""
        t, keep = self.t, self.t in self.keep_at
        self.attempted += 1
        a = time.perf_counter()
        try:
            new, rec = self.prog.tick(self.state, t, keep)
            cmd = rec["cmd"].cpu()
        except Exception as exc:          # a tick that raises fails
            self.failed += 1
            raise RuntimeError(f"tick {t} raised: {exc!r}") from exc
        self.latencies.append(time.perf_counter() - a)
        if not _finite(cmd):
            self.failed += 1
        if keep:
            self.kept[t] = (self.state, rec)
        self.state, self.t = new, t + 1
        return rec


def _traced_tail(loop: _Loop, tr_cfg: dict, program: str, kernels: dict,
                 tr_mod):
    """After a traced window: ``sync_ticks`` ticks counted for host syncs,
    then ``profile_ticks`` ticks profiled with the kernels' arguments kept
    (the profiler leaves the host slower, so it comes last). Returns
    (syncs, the profiler, {kernel: [args of each call]})."""
    def syncing():
        for _ in range(tr_cfg["sync_ticks"]):
            loop.tick()
    syncs, _ = tr_mod.sync_count(syncing)
    calls = {name: [] for name in kernels}

    def grab(name, fn):
        def kept(*args):
            calls[name].append(args)
            return fn(*args)
        return kept

    def profiling():
        with tr_mod.patched(program, kernels, grab):
            for _ in range(tr_cfg["profile_ticks"]):
                loop.tick()
    _, prof = tr_mod.profiled(profiling)
    return syncs, prof, calls


def _report_fills(config: dict, kept: dict, log):
    """How full the cell keeps the program's caps (marked cells, obstacle
    points), over the compared ticks: a line of the log. A reading over
    100 % means that the program drops what lies past the cap."""
    robots = config["robots"]
    for name, (path, budget) in config.get("report", {}).items():
        vals = [float(resolve_path(rec, path).reshape(robots, -1).sum(1)
                      .float().mean()) for _, rec in kept.values()]
        if vals:
            log(f"fill {name}: mean {np.mean(vals):.1f} against a cap of "
                f"{budget} ({100 * np.mean(vals) / budget:.1f} %; over 100 "
                f"% the program uses only the cap) over the {len(vals)} "
                f"compared ticks")


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             program: str = PROGRAM, program_context=None,
             t0: float = None, log=None) -> dict:
    """One run of ``cell``. ``program`` names the package under test (the
    reference stands in for it in the control); ``program_context()``, when
    given, is a context manager around the program's ticks (a lower
    precision or a planted fault) from the program's set-up to the
    window's end. Returns the result line as a dict."""
    import contextlib

    import torch

    from navbench import trace as tr_mod
    from navbench.bounds import bound_us
    from navbench.spec import load_generator, load_reader, load_system
    from navbench.world import build_world

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    t0 = T0 if t0 is None else t0
    config, tp = cell.config, cell.traffic
    cuda = device != "cpu"
    sysmod = load_system(config["system"])
    marks = [("imports", time.perf_counter())]
    world = build_world(config["map"])
    traffic = load_generator(tp["generator"])(world, config, tp, seed,
                                              device)
    marks.append(("world and traffic", time.perf_counter()))
    log(f"traffic: {describe(traffic)}")
    stack = contextlib.ExitStack()
    stack.enter_context((program_context or contextlib.nullcontext)())
    prog = Side(program, sysmod, config, world, traffic, device)
    marks.append(("program tables and state", time.perf_counter()))
    chain, forced = check_ticks(tp["check"], seed)
    loop = _Loop(prog, set(chain) | set(forced))
    start = prog.built.state0
    timer = tr_mod.StageTimer(cuda)
    counters, error = {}, None
    syncs = prof = calls = None
    with stack, tr_mod.patched(program, config["stages"] if trace else {},
                               timer.wrap):
        try:
            for _ in range(tp["warmup_ticks"]):
                loop.tick()
        except RuntimeError as exc:
            error = str(exc)
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        marks.append(("warm-up ticks", time.perf_counter()))
        warm = len(loop.latencies)
        parts = ", ".join(f"{name} {b - a:.2f} s" for (_, a), (name, b)
                          in zip([("start", t0)] + marks, marks))
        log(f"set-up {setup_s:.3f} s ({parts}); window of {seconds} s "
            f"from tick {loop.t}")
        w0 = time.perf_counter()
        try:
            while error is None and time.perf_counter() - w0 < seconds:
                if trace:
                    timer.tick()
                rec = loop.tick()
                if trace:
                    for name, path in config.get("counters", {}).items():
                        counters.setdefault(name, []).append(
                            resolve_path(rec, path))
        except RuntimeError as exc:
            error = str(exc)
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - w0
        ticks = np.asarray(loop.latencies[warm:]) * 1e3
        if trace and cuda and error is None:
            try:
                syncs, prof, calls = _traced_tail(
                    loop, tp["trace"], program, config.get("kernels", {}),
                    tr_mod)
            except RuntimeError as exc:
                error = str(exc)
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0
    failed = loop.failed
    attempted = len(ticks) + (failed if error else 0)
    log(f"window: {len(ticks)} ticks in {window_s:.3f} s, {failed} failed")
    _report_fills(config, loop.kept, log)

    record = None
    if trace:
        record = dict(
            robots=config["robots"], stage_ms=timer.times(),
            counters={k: torch.stack(v).float().cpu().numpy()
                      for k, v in counters.items()},
            device_trace=tr_mod.DeviceTrace(prof.events()) if prof else None,
            profiled_ticks=tp["trace"]["profile_ticks"] if prof else 0,
            syncs=syncs, sync_ticks=tp["trace"]["sync_ticks"],
            kernel_bound={})
        for name, args in (calls or {}).items():
            if args:
                b = [bound_us(name, a) for a in args]
                record["kernel_bound"][name] = (
                    sum(x for x, _ in b), len(args), sorted({s for _, s in b}))
                log(f"bound {name}: {sum(x for x, _ in b):.3f} us over "
                    f"{len(args)} calls, set by "
                    f"{', '.join(sorted({s for _, s in b}))}")
        calls = prof = None
    kept, loop, prog = loop.kept, None, None
    if cuda:
        torch.cuda.empty_cache()

    checks = compare(sysmod, config, world, traffic, device, start, kept,
                     chain, forced, log)
    correct = (error is None and failed == 0
               and all(c["value"] <= c["limit"] for c in checks.values()))
    if error:
        log(f"error: {error}")

    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        q = np.percentile(ticks, [5, 25, 50, 75, 95, 99, 100]) if len(
            ticks) else []
        log(f"ticks {len(ticks)}: p5/p25/p50/p75/p95/p99/max "
            f"{'/'.join(f'{x:.1f}' for x in q)} ms")
        values = {
            "tick_p95_ms": (float(np.percentile(ticks, 95)) if len(ticks)
                            else math.inf),
            "robot_ticks_per_s": config["robots"] * len(ticks) / window_s,
            "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(mem_peak)}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    tr = record["device_trace"] if record else None
    if tr is not None:
        dev["busy_s"] = tr.busy_us * 1e-6
        dev["window_s"] = tr.window_us * 1e-6
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = checks
    return out


def compare(sysmod, config, world, traffic, device, start, kept, chain,
            forced, log) -> dict:
    """The reference's readings against the program's records: its own
    start state and chain of ``chain`` ticks, then each ``forced`` tick the
    window reached, recomputed from the program's state before it. Returns
    {number: {"value", "limit"}} over the configuration's ``compare``
    groups (see :func:`reading`) and ``start`` (:func:`diff`)."""
    import torch
    t0 = time.perf_counter()
    ref = Side(REFERENCE, sysmod, config, world, traffic, device)
    groups = config["compare"]
    limits = config["limits"]
    worst = {g: 0.0 for g in groups}
    worst["start"] = diff(start, ref.built.state0)
    state, n = ref.built.state0, 0
    for t in chain:
        if t not in kept:
            worst = {g: math.inf for g in worst}
            break
        state, rec = ref.tick(state, t, keep=True)
        for g, group in groups.items():
            worst[g] = max(worst[g], reading(group, kept[t][1], rec))
        n += 1
    for t in forced:
        if t not in kept:
            continue
        pre = to_side(kept[t][0], REFERENCE)
        _, rec = ref.tick(pre, t, keep=True)
        for g, group in groups.items():
            worst[g] = max(worst[g], reading(group, kept[t][1], rec))
        n += 1
    if device != "cpu":
        torch.cuda.synchronize()
    log(f"reference: {n} ticks compared ({len(chain)} from its own start, "
        f"the rest from the program's state) in "
        f"{time.perf_counter() - t0:.3f} s")
    return {g: {"value": v, "limit": limits[g]} for g, v in worst.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    from navbench.spec import Cell, load_benchmark
    bench_path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.isfile(bench_path):
        print(f"no BENCHMARK.json at {ROOT}", file=sys.stderr)
        return 2
    import torch
    cell = Cell(load_benchmark(bench_path), args.workload)
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        print(f"the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, PROGRAM)):
        print(f"the program ({PROGRAM}) is not in {ROOT}", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
