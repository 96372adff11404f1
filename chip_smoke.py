"""Smoke run of the PyTorch port (dddmr_navigation_tpu_torch) on one CUDA
card, at the full width of the 64-robot headline fleet.

    python3 chip_smoke.py

In order, and any failed check raises (exit code 1):
  1. requires CUDA;
  2. builds the hand-written kernels from ``dddmr_navigation_tpu_torch/csrc``
     and prints the build time and ptxas's report;
  3. holds each kernel against its plain PyTorch version on the card, on
     the inputs the headline chain gives it at ticks 0, 25 and 49: hits
     equal exactly, and the plain hits must hold both outcomes so that the
     comparison can fail; distances within rtol 1e-6 (expected bit equal:
     the same operation order, no FMA); prints each one's error and time,
     kernel and plain, from CUDA events;
  4. runs the 64-robot, 50-tick chain on the kernel path and on the plain
     path: per-tick state codes, best indices and found counts must be
     equal, and the launch counters must show each kernel launched as
     often as the chain calls it (one collision sweep and two distance
     calls per tick);
  5. holds tick 0, and the state codes of every tick of the chain, against
     the JAX package's golden file
     (``dddmr_navigation_tpu_torch/testdata/headline_tick0.npz``);
  6. times the chain tick by tick with CUDA events: median, p95 and p99 ms,
     the spread of the per-chain medians, and rollouts/s, beside the card's
     name and power limit; then profiles
     a few ticks for device time by kernel and the device's busy share.

The line before the last is one JSON object with each kernel's route,
source, launches, error and time; the last line is
``{"ok": true, "device": {...}}``. TF32 is off (nothing on the tick is a
matmul, so it would change nothing).
"""
import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
TICKS = 50
ROBOTS = 64
TIMED_CHAINS = 10
KERNEL_REPS = 50
PROFILED_TICKS = 5
CHECK_TICKS = (0, TICKS // 2, TICKS - 1)   # kernel vs plain at these ticks


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps):
    """Mean ms per call of ``fn`` over ``reps`` calls, from CUDA events,
    after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def critics_calling(hits_fn, dist_fn):
    """Point the critics at other functions for the two kernel calls."""
    from dddmr_navigation_tpu_torch.planning.local import critics
    saved = critics.swept_box_hits, critics.masked_min_distance
    critics.swept_box_hits, critics.masked_min_distance = hits_fn, dist_fn
    try:
        yield
    finally:
        critics.swept_box_hits, critics.masked_min_distance = saved


def main():
    import numpy as np
    import torch

    check(torch.cuda.is_available(), "no CUDA device")
    check(os.path.isdir(os.path.join(ROOT, "dddmr_navigation_tpu_torch")),
          f"no dddmr_navigation_tpu_torch package beside {__file__}")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from dddmr_navigation_tpu_torch import entry, ops
    from dddmr_navigation_tpu_torch.ops import build

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path, report = build.build()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(lib_path, ROOT)}")
    for line in report.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    cfg = entry.headline_config()
    plans, state, obstacles, obs_valid = entry.headline_inputs(
        cfg, ROBOTS, dev)
    samples = cfg.generator.n_samples_padded

    # 3. each kernel against its plain version, on the arguments the chain
    # gives it at CHECK_TICKS. Tick 0's collision sweep cannot hit anything
    # (the robots stand still, every obstacle is beyond the swept boxes), so
    # later ticks, where some samples hit and others do not, are checked too.
    per_tick = {"swept_box_hits": 1, "masked_min_distance": 2}
    calls = {name: [] for name in per_tick}
    seen = dict.fromkeys(per_tick, 0)

    def recorder(name, fn):
        def rec(*args):
            if seen[name] // per_tick[name] in CHECK_TICKS:
                calls[name].append((seen[name] // per_tick[name], args))
            seen[name] += 1
            return fn(*args)
        return rec

    with critics_calling(recorder("swept_box_hits", ops.swept_box_hits),
                         recorder("masked_min_distance",
                                  ops.masked_min_distance)):
        entry.run_chain(cfg, plans, state, obstacles, obs_valid,
                        max(CHECK_TICKS) + 1)
    torch.cuda.synchronize()
    check(all(len(calls[k]) == per_tick[k] * len(CHECK_TICKS)
              for k in calls),
          f"unexpected kernel calls per tick: "
          f"{ {k: len(v) for k, v in calls.items()} }")

    kernels = {
        "swept_box_hits": dict(
            kernel=ops.swept_box_hits, plain=ops.swept_box_hits_plain,
            source="dddmr_navigation_tpu_torch/csrc/swept_box_hits.cu",
            replaces="dddmr_navigation_tpu/ops/collision.py:122"),
        "masked_min_distance": dict(
            kernel=ops.masked_min_distance,
            plain=ops.masked_min_distance_plain,
            source="dddmr_navigation_tpu_torch/csrc/masked_min_distance.cu",
            replaces="dddmr_navigation_tpu/ops/distance_field.py:91"),
    }
    for name, k in kernels.items():
        k.update(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
        hits = total = 0
        for t, args in calls[name]:
            got = k["kernel"](*args)
            want = k["plain"](*args)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{name}: {got.shape}/{got.dtype} vs plain "
                  f"{want.shape}/{want.dtype}")
            if got.dtype == torch.bool:
                err = float((got != want).sum())
                check(err == 0, f"{name} tick {t}: {int(err)} hits differ "
                      f"from plain")
                hits += int(want.sum())
                total += want.numel()
                what = f"{int(want.sum())}/{want.numel()} hits"
            else:
                check(bool((want < 1e6).any()),
                      f"{name} tick {t}: every plain distance is masked")
                err = float((got - want).abs().max())
                rel = ((got - want).abs()
                       / want.abs().clamp_min(1e-30)).max().item()
                check(rel <= 1e-6, f"{name} tick {t}: rel err {rel} > 1e-6")
                what = f"{int((want < 1e6).sum())}/{want.numel()} unmasked"
            ms = cuda_ms(lambda: k["kernel"](*args), KERNEL_REPS)
            plain_ms = cuda_ms(lambda: k["plain"](*args), KERNEL_REPS)
            shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
            print(f"{name} tick {t} {shapes} ({what}): max_abs_err {err!r} "
                  f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
            k["max_abs_err"] = max(k["max_abs_err"], err)
            # per tick: all of a tick's calls, averaged over CHECK_TICKS
            k["ms"] += ms / len(CHECK_TICKS)
            k["plain_ms"] += plain_ms / len(CHECK_TICKS)
        if name == "swept_box_hits":
            # both outcomes occur, so a kernel that never (or always) hits
            # disagrees with the plain version above
            check(0 < hits < total, f"{name}: the plain version gives "
                  f"{hits}/{total} hits at ticks {CHECK_TICKS}; the "
                  f"comparison could not fail")

    # 4. the 50-tick chain, through the kernels, then through the plain
    # versions; the launch counters are read around the kernel run only
    ops.swept_box_hits.launches = 0
    ops.masked_min_distance.launches = 0
    chain = entry.run_chain(cfg, plans, state, obstacles, obs_valid, TICKS)
    torch.cuda.synchronize()
    launches = {"swept_box_hits": ops.swept_box_hits.launches,
                "masked_min_distance": ops.masked_min_distance.launches}
    print(f"launches in the {TICKS}-tick chain: {launches}")
    check(launches == {"swept_box_hits": TICKS,
                       "masked_min_distance": 2 * TICKS},
          f"launch counts {launches}, expected {TICKS} and {2 * TICKS}")
    with critics_calling(ops.swept_box_hits_plain,
                         ops.masked_min_distance_plain):
        plain = entry.run_chain(cfg, plans, state, obstacles, obs_valid, TICKS)
    torch.cuda.synchronize()
    check(ops.swept_box_hits.launches == TICKS
          and ops.masked_min_distance.launches == 2 * TICKS,
          "plain chain launched a kernel")
    for field in ("state", "best_index", "found"):
        a, b = getattr(chain, field), getattr(plain, field)
        check(torch.equal(a, b), f"chain {field} differs kernel vs plain: "
              f"{torch.nonzero(a != b)[:5].tolist()}")
    pos_err = float((chain.final.pos - plain.final.pos).abs().max())
    check(bool(torch.isfinite(chain.final.pos).all()), "non-finite poses")
    print(f"chain: found per tick {chain.found.tolist()}; final pose diff "
          f"kernel vs plain {pos_err!r} m; travelled "
          f"{float((chain.final.pos - state.pos)[:, 0].mean()):.3f} m")

    # 5. tick 0 against the JAX package
    g = np.load(os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                             "headline_tick0.npz"))
    st, bi = chain.state[0].cpu().numpy(), chain.best_index[0].cpu().numpy()
    vx, wz = chain.vx[0].cpu().numpy(), chain.wz[0].cpu().numpy()
    check(np.array_equal(st, g["state"]), "tick 0 state differs from JAX")
    ties = 0
    for b in np.flatnonzero(bi != g["best_index"]):
        gap = abs(float(g["costs"][b, bi[b]] - g["costs"][b, g["best_index"][b]]))
        check(gap <= 1e-5, f"robot {b}: best index {bi[b]} vs JAX "
              f"{g['best_index'][b]}, cost gap {gap}")
        ties += 1
    dvx = float(np.abs(vx - g["vx"]).max())
    dwz = float(np.abs(wz - g["wz"]).max())
    check(dvx <= 1e-5 and dwz <= 1e-5, f"tick 0 vx/wz off JAX: {dvx} {dwz}")
    print(f"golden tick 0: states equal, best index equal on "
          f"{ROBOTS - ties}/{ROBOTS} robots ({ties} ties within 1e-5), "
          f"max |dvx| {dvx!r} |dwz| {dwz!r}")
    codes = chain.state.cpu().numpy()
    bad = np.argwhere(codes != g["chain_state"][:TICKS])
    check(bad.size == 0, f"chain state codes differ from JAX at (tick, robot) "
          f"{bad[:5].tolist()}")
    print(f"golden chain: all {codes.size} state codes of the {TICKS}-tick "
          f"chain equal JAX's")

    # 6. per-tick time, CUDA events around each tick
    def timed(n_chains):
        """Per-tick ms (n_chains × TICKS, chain by chain) and host wall ms
        per tick of each chain."""
        per_tick, wall = [], []
        for _ in range(n_chains):
            s = state
            events = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TICKS):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                s, _cmd = entry.tick(cfg, plans, s, obstacles, obs_valid)
                e1.record()
                events.append((e0, e1))
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) / TICKS * 1e3)
            per_tick += [a.elapsed_time(b) for a, b in events]
        return np.asarray(per_tick), np.asarray(wall)

    timed(1)                                      # warm-up
    ticks_ms, wall_ms = timed(TIMED_CHAINS)
    with critics_calling(ops.swept_box_hits_plain,
                         ops.masked_min_distance_plain):
        plain_ms, _ = timed(2)
    med = float(np.median(ticks_ms))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"tick ({ROBOTS} robots x {samples} samples, kernel path, "
          f"n={ticks_ms.size}): median {med!r} ms, p95 "
          f"{float(np.percentile(ticks_ms, 95))!r} ms, p99 "
          f"{float(np.percentile(ticks_ms, 99))!r} ms, host wall per tick "
          f"median {float(np.median(wall_ms))!r} ms; "
          f"{ROBOTS * samples / med * 1e3:.0f} rollouts/s; "
          f"plain path median {float(np.median(plain_ms))!r} ms "
          f"(n={plain_ms.size}); card {card}")
    chain_medians = np.median(ticks_ms.reshape(TIMED_CHAINS, TICKS), axis=1)
    print(f"per-chain tick medians ({TIMED_CHAINS} chains, kernel path): "
          f"min {float(chain_medians.min())!r} ms, max "
          f"{float(chain_medians.max())!r} ms, max/min "
          f"{float(chain_medians.max() / chain_medians.min())!r}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f}"
          f" MiB")

    # where a tick's device time goes: kernel time by name over a window
    # of PROFILED_TICKS ticks, and the device's busy share of that window
    from torch.profiler import ProfilerActivity, profile
    s = state
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        e0.record()
        for _ in range(PROFILED_TICKS):
            s, _cmd = entry.tick(cfg, plans, s, obstacles, obs_valid)
        e1.record()
        torch.cuda.synchronize()
    window_us = e0.elapsed_time(e1) * 1e3
    device = [(ev.key, ev.self_device_time_total, ev.count)
              for ev in prof.key_averages()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(t for _, t, _ in device)
    n_kernels = sum(c for _, _, c in device)
    if busy_us > 0:
        print(f"profile ({PROFILED_TICKS} ticks): device busy "
              f"{busy_us / PROFILED_TICKS:.1f} us/tick of "
              f"{window_us / PROFILED_TICKS:.1f} us/tick "
              f"({100 * busy_us / window_us:.1f}% busy), "
              f"{n_kernels / PROFILED_TICKS:.0f} device kernels per tick")
        for key, t, c in sorted(device, key=lambda d: -d[1])[:10]:
            print(f"  {t / PROFILED_TICKS:9.1f} us/tick  {c / PROFILED_TICKS:5.1f}"
                  f" calls/tick  {key[:90]}")
        for name in kernels:
            mine = [(t, c) for key, t, c in device if f"{name}_kernel" in key]
            t, c = sum(m[0] for m in mine), sum(m[1] for m in mine)
            print(f"  kernel {name}: device {t / PROFILED_TICKS:.1f} us/tick "
                  f"over {c / PROFILED_TICKS:.0f} launches/tick")
    else:
        print("profile: no device time recorded (device busy share not "
              "measured)")

    print(card)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": k["source"],
         "replaces": k["replaces"], "launches": launches[name],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"]} for name, k in kernels.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
