"""Time variants of the port's two CUDA kernels on the card, per call, in
turns with the unmodified source.

    python3 tools/kernel_variants.py

Each variant is the kernel's source with a few lines replaced (the warp
tile of ``swept_box_hits``; the queries a thread owns and the warps a block
holds in ``masked_min_distance``), compiled by nvcc into its own library
under ``_build/variants/``. The calls are those of the headline chain at
ticks 25 and 49 and of the fused config-3 chain (with the extra box of
``chip_smoke.py``) at ticks 0, 10 and 19. Every variant must equal the
plain PyTorch version bit for bit; each prints its profiler device µs per
call, in the order variants, variants reversed, the first of each kernel's
(``"8x4"``, ``"qpt4"``) being the unmodified source, so that it opens and
closes the turns, and the sum over the calls. Needs one CUDA card.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "dddmr_navigation_tpu_torch", "_build", "variants")
TILE = ("constexpr int kTileSamples = 8;             // a warp's tile: 8 "
        "samples\nconstexpr int kTileSteps = 4;               //   x 4 "
        "steps = 32 rows")
WIDE = ("masked_min_distance_kernel<4><<<",
        "(Q + 4 * kThreads - 1) / (4 * kThreads)")
WARPS = "constexpr int kWarps = 4;               // warps per block"
VARIANTS = {
    "swept_box_hits": {
        "8x4": [],
        **{f"{s}x{n}": [(TILE, f"constexpr int kTileSamples = {s};\n"
                               f"constexpr int kTileSteps = {n};")]
           for s, n in ((4, 8), (2, 16), (1, 32))}},
    "masked_min_distance": {
        "qpt4": [],
        "qpt8": [(WIDE[0], "masked_min_distance_kernel<8><<<"),
                 (WIDE[1], "(Q + 8 * kThreads - 1) / (8 * kThreads)")],
        "qpt1": [("constexpr long long kWideFrom = 1 << 17;",
                  "constexpr long long kWideFrom = 1LL << 62;")],
        "warps2": [(WARPS, "constexpr int kWarps = 2;")]},
}
FUSED_BOX = ((9.1, 7.6, 0.0), (9.5, 8.0, 1.0))


def build_variants(build):
    """{kernel: {variant: ctypes library}}, every variant compiled at once."""
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for kernel, variants in VARIANTS.items():
        src = open(os.path.join(ROOT, "dddmr_navigation_tpu_torch", "csrc",
                                f"{kernel}.cu")).read()
        for name, subs in variants.items():
            text = src
            for old, new in subs:
                if old not in text:
                    raise SystemExit(f"{kernel} {name}: {old!r} not found")
                text = text.replace(old, new)
            path = os.path.join(OUT, f"{kernel}_{name}.cu")
            with open(path, "w") as f:
                f.write(text)
            lib = path[:-3] + ".so"
            jobs[kernel, name] = (lib, subprocess.Popen(
                [build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", lib,
                 path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for (kernel, name), (lib, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {kernel} {name}:\n{out}")
        handle = ctypes.CDLL(lib)
        entry = f"{kernel}_launch"
        getattr(handle, entry).argtypes = build.SIGNATURES[entry]
        getattr(handle, entry).restype = ctypes.c_int
        libs.setdefault(kernel, {})[name] = handle
    return libs


def record_calls(np, torch, dev, entry, ops):
    """{(kernel, phase, tick, index): args} of the two chains."""
    from dddmr_navigation_tpu_torch.planning.local import critics
    calls, seen = {}, {}

    def recorder(kernel, phase, ticks, per_tick, fn):
        def rec(*args):
            n = seen.get((kernel, phase), 0)
            if n // per_tick in ticks:
                calls[kernel, phase, n // per_tick, n % per_tick] = args
            seen[kernel, phase] = n + 1
            return fn(*args)
        return rec

    def record(phase, ticks, run):
        critics.swept_box_hits = recorder("swept_box_hits", phase, ticks, 1,
                                          ops.swept_box_hits)
        critics.masked_min_distance = recorder(
            "masked_min_distance", phase, ticks, 2, ops.masked_min_distance)
        try:
            run()
        finally:
            critics.swept_box_hits = ops.swept_box_hits
            critics.masked_min_distance = ops.masked_min_distance

    cfg = entry.headline_config()
    plans, state, obs, obs_valid = entry.headline_inputs(cfg, 64, dev)
    record("headline", (25, 49),
           lambda: entry.run_chain(cfg, plans, state, obs, obs_valid, 50))
    g = np.load(os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                             "config3_golden.npz"))
    cfg3 = entry.config3_config()
    c3 = entry.config3_inputs(cfg3, dev)
    world = entry.config3_world([FUSED_BOX])
    scans, masks = [], []
    for t in range(20):
        pts, mask = entry.config3_scan(cfg3, world, g["positions"][t],
                                       float(g["yaws"][t]))
        scans.append(torch.as_tensor(pts, device=dev)[None])
        masks.append(torch.as_tensor(mask, device=dev)[None])
    poses = [torch.as_tensor(g[k], device=dev)[:, None]
             for k in ("positions", "quats", "v_in", "w_in")]
    record("fused", (0, 10, 19),
           lambda: entry.run_fused_chain(c3, entry.config3_state(c3), scans,
                                         masks, *poses))
    torch.cuda.synchronize()
    return calls


def launch(torch, dev, lib, kernel, args):
    entry_name = f"{kernel}_launch"
    stream = torch.cuda.current_stream().cuda_stream
    if kernel == "swept_box_hits":
        axes, projc, valid, obs, obs_valid, half = args
        b, s, n = valid.shape
        out = torch.zeros((b, s), dtype=torch.uint8, device=dev)
        err = getattr(lib, entry_name)(
            axes.data_ptr(), projc.data_ptr(), valid.data_ptr(),
            obs.data_ptr(), obs_valid.data_ptr(), b, s, n, obs.shape[1],
            *map(float, half), out.data_ptr(), stream)
        out = out.view(torch.bool)
    else:
        queries, q_mask, points, p_mask = args
        b, q, _ = queries.shape
        out = torch.empty((b, q), dtype=torch.float32, device=dev)
        err = getattr(lib, entry_name)(
            queries.data_ptr(), q_mask.data_ptr(), points.data_ptr(),
            p_mask.data_ptr(), b, q, points.shape[1], out.data_ptr(), stream)
    if err != 0:
        raise SystemExit(f"{entry_name} failed: cudaError_t {err}")
    return out


def device_us(torch, fn, key, reps=20):
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and key in ev.key) / reps


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: needs a CUDA device")
    sys.path.insert(0, ROOT)
    from dddmr_navigation_tpu_torch import entry, ops
    from dddmr_navigation_tpu_torch.ops import build
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    libs = build_variants(build)
    calls = record_calls(np, torch, dev, entry, ops)
    plain = {"swept_box_hits": ops.swept_box_hits_plain,
             "masked_min_distance": ops.masked_min_distance_plain}
    for kernel, variants in VARIANTS.items():
        order = [*variants, *reversed(list(variants))]
        totals = {}
        for (k, phase, tick, index), args in calls.items():
            if k != kernel:
                continue
            want = plain[kernel](*args)
            times = {}
            for name in order:
                lib = libs[kernel][name]
                got = launch(torch, dev, lib, kernel, args)
                if not torch.equal(got, want):
                    raise SystemExit(f"{kernel} {name} differs from plain at "
                                     f"{phase} tick {tick}")
                times.setdefault(name, []).append(device_us(
                    torch, lambda: launch(torch, dev, lib, kernel, args),
                    f"{kernel}_kernel"))
            for name, ts in times.items():
                totals[name] = totals.get(name, 0.0) + sum(ts) / len(ts)
            print(f"{kernel} {phase} tick {tick} call {index} "
                  f"{tuple(args[0].shape)}: device us "
                  + ", ".join(f"{n} {'/'.join(f'{t:.2f}' for t in ts)}"
                              for n, ts in times.items()), flush=True)
        print(f"{kernel} summed over the calls: "
              + ", ".join(f"{n} {t:.2f} us" for n, t in totals.items()))


if __name__ == "__main__":
    main()
