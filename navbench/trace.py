"""What a traced run records: stage times, the profiler's device trace,
host syncs and the kernels' arguments.

* Stage times: each stage function the configuration lists is wrapped, in
  its module (a method on its class), by a function that records a CUDA
  event before and after it (the host clock on the CPU); the tick looks
  the stage up by name, so no tick body is copied.
* The device trace: ``torch.profiler`` over a few ticks, opened by
  ``PROFILE_LEAD`` launches of a lead kernel (``erfcx``, which no tick
  runs): on the H100 the profiler drops a profile's first device records
  (``chip_smoke.py::profiled``, frozen here). The device's busy time is
  the union of the kernel intervals, so that two streams' overlapping
  kernels count once.
* Host syncs: CUDA's sync debug mode warns at each sync
  (``chip_smoke.py::sync_sites``, frozen here).
* Kernel arguments: the two kernel entry points are wrapped where the
  critics look them up, so each call's arguments are kept for the bound
  arithmetic of :mod:`navbench.bounds`.
"""
from __future__ import annotations

import bisect
import contextlib
import importlib
import time
import warnings

import torch

PROFILE_LEAD = 64
ANNOTATIONS = ("navbench:", "stage:")   # the harness's profiler ranges
_ABSENT = object()


def resolve(pkg: str, target: str):
    """(owner, attribute) of ``"module.path:attr"`` under ``pkg``, the
    owner being the module, or of ``"module.path:Class.attr"``, the owner
    being the class whose method it names."""
    mod, attr = target.split(":")
    owner = importlib.import_module(f"{pkg}.{mod}")
    *classes, attr = attr.split(".")
    for name in classes:
        owner = getattr(owner, name)
    return owner, attr


@contextlib.contextmanager
def patched(pkg: str, targets: dict, make):
    """Replace each ``targets`` value (see :func:`resolve`) by
    ``make(name, original)`` for the duration, a method on its class;
    then put back what the owner held itself, and take the wrapper off
    where it held nothing (an inherited method)."""
    saved = []
    try:
        for name, target in targets.items():
            owner, attr = resolve(pkg, target)
            saved.append((owner, attr, vars(owner).get(attr, _ABSENT)))
            setattr(owner, attr, make(name, getattr(owner, attr)))
        yield
    finally:
        for owner, attr, own in reversed(saved):
            if own is _ABSENT:
                delattr(owner, attr)
            else:
                setattr(owner, attr, own)


class StageTimer:
    """Events around each stage call; ``times()`` after a synchronize
    gives {stage: [ms per tick]} over the ticks marked by ``tick()``.
    Every call is also a profiler range ``stage:<name>``, which names the
    idle gaps of a profiled tick."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.ticks = []          # [{stage: [(start, end)]}]

    def tick(self):
        self.ticks.append({})

    def _mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def wrap(self, name, fn):
        def timed(*args, **kwargs):
            with torch.profiler.record_function(f"stage:{name}"):
                if not self.ticks:
                    return fn(*args, **kwargs)
                start = self._mark()
                out = fn(*args, **kwargs)
                end = self._mark()
            self.ticks[-1].setdefault(name, []).append((start, end))
            return out
        return timed

    def times(self) -> dict:
        out = {}
        for tick in self.ticks:
            for name, spans in tick.items():
                ms = sum(a.elapsed_time(b) if self.cuda else 1e3 * (b - a)
                         for a, b in spans)
                out.setdefault(name, []).append(ms)
        return out


def sync_count(fn):
    """Run ``fn`` with CUDA's sync debug mode on. Returns (host syncs,
    fn's result)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught), out


def is_lead(name: str) -> bool:
    return "erfcx" in name


def profiled(run):
    """``run()`` under the profiler (CPU and CUDA activities), after
    ``PROFILE_LEAD`` lead launches. Returns (run's result, the profiler),
    whose events are read later (reading them takes seconds)."""
    from torch.profiler import ProfilerActivity, profile
    one = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_LEAD):
            torch.special.erfcx(one)
        torch.cuda.synchronize()
        with torch.profiler.record_function("navbench:window"):
            out = run()
            torch.cuda.synchronize()
    return out, prof


def _union(intervals):
    """Total length of the union of (start, end) intervals, and the gaps
    between them as (start, end)."""
    total, gaps, cur = 0.0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            total += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


class DeviceTrace:
    """The profiled window's device kernels and host activity, in µs of
    the profiler's clock."""

    def __init__(self, events):
        win = [e for e in events if e.name == "navbench:window"
               and e.device_type == torch.autograd.DeviceType.CPU]
        self.window = (win[0].time_range.start, win[0].time_range.end)
        w0, w1 = self.window
        self.kernels = []            # (name, start, end) inside the window
        host, stages = [], []
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if e.name.startswith(ANNOTATIONS):
                    continue            # the ranges below, on the GPU row
                if is_lead(e.name):
                    continue
                s, t = e.time_range.start, e.time_range.end
                if t > w0 and s < w1:
                    self.kernels.append((e.name, max(s, w0), min(t, w1)))
            elif e.name.startswith("aten::"):
                host.append((e.time_range.start, e.time_range.end, e.name))
            elif e.name.startswith("stage:"):
                stages.append((e.time_range.start, e.time_range.end,
                               e.name[6:]))
        host.sort()
        stages.sort()
        self.host, self.stages = host, stages
        self.host_starts = [h[0] for h in host]
        self.stage_starts = [s[0] for s in stages]
        self.busy_us, self.gaps = _union((s, t) for _, s, t in self.kernels)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def kernel_us(self, key: str) -> tuple:
        """(device µs, launches) of the kernels whose name holds ``key``."""
        mine = [t - s for name, s, t in self.kernels if key in name]
        return sum(mine), len(mine)

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, s, t in self.kernels:
            by[name] = by.get(name, 0.0) + (t - s)
        return [[k[:120], v * 1e-6] for k, v in sorted(
            by.items(), key=lambda kv: -kv[1])[:n]]

    def _host_at(self, t: float) -> str:
        """The innermost stage and host operation running at ``t``."""
        stage = "outside stages"
        j = bisect.bisect_right(self.stage_starts, t)
        if j and self.stages[j - 1][1] >= t:
            stage = self.stages[j - 1][2]
        i = bisect.bisect_right(self.host_starts, t)
        op, op_len = "python", None
        for s, e, name in reversed(self.host[max(0, i - 400):i]):
            if e >= t and (op_len is None or e - s < op_len):
                op, op_len = name, e - s
        return f"{stage} / {op}"

    def idle_gaps(self, n: int = 10) -> list:
        """The idle time between kernels, summed by what the host was
        doing at the middle of each gap; the ``n`` largest."""
        w0, w1 = self.window
        gaps = list(self.gaps)
        if self.kernels:
            first = min(s for _, s, _ in self.kernels)
            last = max(t for _, _, t in self.kernels)
            gaps = [(w0, first)] + gaps + [(last, w1)]
        by = {}
        for s, e in gaps:
            if e > s:
                key = self._host_at(0.5 * (s + e))
                by[key] = by.get(key, 0.0) + (e - s)
        return [[k, v * 1e-6] for k, v in sorted(
            by.items(), key=lambda kv: -kv[1])[:n]]
