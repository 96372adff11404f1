"""Shared arithmetic of the per-layer metric readers (``metrics/*.py``).

Each reader's ``read(record)`` returns a number, or None when the run
recorded nothing it can read (the harness then leaves the metric out).
The record of a traced run holds ``robots``, ``stage_ms`` ({stage: [ms a
tick]} over the event-timed ticks), ``counters`` ({name: (ticks, B)}),
``device_trace`` (:class:`navbench.trace.DeviceTrace` of the profiled
ticks, or None), ``profiled_ticks``, ``syncs`` and ``sync_ticks``, and
``kernel_bound`` ({kernel: (bound µs summed, calls, what sets it)} over
the profiled ticks).
"""
from __future__ import annotations

import numpy as np


def stage_ms(record, stages) -> float | None:
    """Mean ms a tick of the named stages together."""
    per = [record["stage_ms"].get(s) for s in stages]
    if not per or any(not p for p in per):
        return None
    return float(np.mean(np.sum(np.asarray(per, dtype=np.float64), axis=0)))


def counter_mean(record, name) -> float | None:
    """Mean of a counter over every robot-tick it was read on."""
    v = record["counters"].get(name)
    if v is None or v.size == 0:
        return None
    return float(v.mean())


def launches_per_tick(record) -> float | None:
    tr = record["device_trace"]
    if tr is None or not record["profiled_ticks"]:
        return None
    return len(tr.kernels) / record["profiled_ticks"]


def syncs_per_tick(record) -> float | None:
    if record["syncs"] is None or not record["sync_ticks"]:
        return None
    return record["syncs"] / record["sync_ticks"]


def device_idle_pct(record) -> float | None:
    tr = record["device_trace"]
    if tr is None or tr.window_us <= 0 or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)


def roofline_pct(record, kernel) -> float | None:
    """The bound over the device time of the kernel's launches in the
    profiled ticks; None unless the profile holds every launch made."""
    tr = record["device_trace"]
    got = record["kernel_bound"].get(kernel)
    if tr is None or got is None:
        return None
    bound_us, calls, _ = got
    device_us, launches = tr.kernel_us(f"{kernel}_kernel")
    if launches != calls or device_us <= 0:
        return None
    return 100.0 * bound_us / device_us
