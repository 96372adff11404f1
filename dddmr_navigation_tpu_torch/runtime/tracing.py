"""Profiling/observability (counterpart of
``dddmr_navigation_tpu/runtime/tracing.py``; SURVEY.md §5: the reference's
tracing is ad-hoc gettimeofday blocks + rviz visualization topics).

* :func:`trace` — context manager around a tick window that records a
  ``torch.profiler`` trace (CPU ops, and the card's kernels where there is
  one) and writes it to ``log_dir`` as a Chrome/Perfetto trace file, where
  the JAX package writes an XLA TensorBoard trace.
* :class:`DebugDumper` — npz dumps of named arrays per tick (the
  "visualization topics as observability" role: dGraph clouds, trajectory
  fans, particle clouds become saved arrays a notebook or the rviz bridge
  can render); tensors are copied to the host first.
* The span and counter recorder — the program's own spans (a tick and its
  layers) and counters, kept in memory while the recorder is on
  (:func:`enable` / :func:`disable` / :func:`reset`, :func:`spans`,
  :func:`counters`). Off by default: then :func:`span` and :func:`stage`
  are one check of a module-level flag, and callers guard each counter
  with ``if tracing.on():``, so an unrecorded tick runs no extra tensor op
  and allocates nothing.

  A span holds its name, host start and end (``time.perf_counter_ns()``),
  the index of its parent in :func:`spans` (-1 for a root) and the id of
  its tick: a root span opens a new id, and every span inside it shares
  that id. A :func:`stage` mark ends the open stage span and begins the
  next under the same parent; the parent's end ends the last. While a
  ``torch.profiler`` profile is active, each span also opens the profiler
  range ``span:<name>``, so :func:`trace`'s file shows the spans beside
  the kernels, and :func:`clock_offset_ns` maps the recorder's clock onto
  the profile's. Host counters are integers added to the innermost open
  span; device counters are summed as device tensors and read to the
  host once, by :func:`counters`. Each thread has its own open spans: a
  host counter lands on the innermost span open in the thread that adds
  it, or on none (a worker thread's relaxation with no span of its own),
  and :func:`counters` sums both.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace('/tmp/trace') as prof: step(...)`` → a profile of the
    block in ``log_dir/trace_<time>.json``; ``prof`` is the
    ``torch.profiler.profile`` (``prof.key_averages()``, ...)."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{time.time_ns()}.json"))


def _host(v):
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


class DebugDumper:
    """Per-tick named-array dumps (ring of ``keep`` files)."""

    def __init__(self, directory: str, keep: int = 32, enabled: bool = True):
        self.directory = directory
        self.keep = keep
        self.enabled = enabled
        self._written: list[str] = []
        if enabled:
            os.makedirs(directory, exist_ok=True)

    def dump(self, tick: int, **arrays) -> str | None:
        if not self.enabled:
            return None
        path = os.path.join(self.directory, f"tick_{tick:08d}.npz")
        np.savez(path, **{k: _host(v) for k, v in arrays.items()})
        self._written.append(path)
        while len(self._written) > self.keep:
            old = self._written.pop(0)
            try:
                os.remove(old)
            except OSError:
                pass
        return path


# ---------------------------------------------------------------------------
# the span and counter recorder
# ---------------------------------------------------------------------------

class Span(NamedTuple):
    """One span of :func:`spans`."""
    name: str
    start_ns: int           # host clock, time.perf_counter_ns()
    end_ns: Optional[int]   # None while the span is open
    parent: int             # index in spans() of the enclosing span, or -1
    tick: int               # id of the root span it lies in
    counts: dict            # host counters added while it was innermost
    profiled: bool          # opened under a torch.profiler profile


class _Record:
    """A span as kept: :class:`Span`'s fields, the profiler range while it
    is open, and whether a :func:`stage` mark opened it."""
    __slots__ = ("name", "start", "end", "parent", "tick", "counts",
                 "range", "profiled", "mark")

    def __init__(self, name, start, parent, tick, rng, mark):
        self.name, self.start, self.end = name, start, None
        self.parent, self.tick, self.counts = parent, tick, {}
        self.range, self.profiled, self.mark = rng, rng is not None, mark


_ON = False
_lock = threading.Lock()    # guards the shared lists and dicts below
_records = []       # _Record, in the order they opened
_outside = {}       # host counters added with no span open in their thread
_device = {}        # device counters: name -> device tensor
_next_tick = 0
_generation = 0     # bumped by reset(): every thread's open spans are gone
_local = threading.local()  # .open: the thread's open spans, innermost last


def _open() -> list:
    """The calling thread's open spans (indices into ``_records``)."""
    if getattr(_local, "generation", -1) != _generation:
        _local.open, _local.generation = [], _generation
    return _local.open


def on() -> bool:
    """Whether the recorder is on (the guard of every counter call)."""
    return _ON


def enable():
    global _ON
    _ON = True


def disable():
    """Stop recording; spans opened while on still end when they close."""
    global _ON
    _ON = False


def reset():
    """Forget every span and counter kept so far, and every open span."""
    global _next_tick, _generation
    with _lock:
        _records.clear()
        _outside.clear()
        _device.clear()
        _next_tick = 0
        _generation += 1


class _Span:
    __slots__ = ("name", "index")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.index = _begin(self.name, False)
        return self

    def __exit__(self, *exc):
        _end(self.index)
        return False


_NULL = contextlib.nullcontext()


def span(name: str):
    """``with tracing.span("plan.relax"): ...`` records the block as a span
    while the recorder is on; a shared no-op context while it is off."""
    if not _ON:
        return _NULL
    return _Span(name)


def child(name: str):
    """:func:`span` inside an open span of the calling thread only: a
    layer of a tick, which a worker thread with no span open (a threaded
    plan manager's query) does not record."""
    if not _ON or not _open():
        return _NULL
    return _Span(name)


def stage(name: str):
    """Ends the open stage span, when the innermost open span is one, and
    begins the stage ``name`` under the same parent (a mark: each stage
    runs from its mark to the next, the last to its parent's end)."""
    if not _ON:
        return
    _mark(name)


def current() -> Optional[str]:
    """The name of the calling thread's innermost open span, or None."""
    opened = _open()
    return _records[opened[-1]].name if opened else None


def count(name: str, n: int = 1):
    """Adds ``n`` to the host counter ``name`` of the calling thread's
    innermost open span (of no span, when it has none open). Call under
    ``if tracing.on():``."""
    opened = _open()
    with _lock:
        counts = _records[opened[-1]].counts if opened else _outside
        counts[name] = counts.get(name, 0) + n


def count_device(name: str, value: torch.Tensor):
    """Adds the integer tensor ``value`` to the device counter ``name``
    without reading it. Call under ``if tracing.on():``."""
    with _lock:
        acc = _device.get(name)
        if acc is None:
            _device[name] = value.detach().to(torch.int64, copy=True)
        else:
            acc.add_(value)


def _begin(name: str, mark: bool) -> int:
    global _next_tick
    opened = _open()
    rng = None
    if torch.autograd._profiler_enabled():
        # the profiler's light range (the one torch.compile emits): its
        # stamps lie within a few µs of the recorder's, where
        # ``record_function``'s first range of a profile lies ~1 ms off
        rng = torch._C._profiler._RecordFunctionFast("span:" + name)
        rng.__enter__()
    with _lock:
        parent = opened[-1] if opened else -1
        if parent < 0:
            tick, _next_tick = _next_tick, _next_tick + 1
        else:
            tick = _records[parent].tick
        _records.append(_Record(name, time.perf_counter_ns(), parent, tick,
                                rng, mark))
        index = len(_records) - 1
    opened.append(index)
    return index


def _end(index: int):
    """Ends span ``index`` and every span still open inside it."""
    opened = _open()
    if index not in opened:
        return
    now = time.perf_counter_ns()
    while opened:
        i = opened.pop()
        if i >= len(_records):      # dropped by a recording() block
            continue
        rec = _records[i]
        rec.end = now
        if rec.range is not None:
            rec.range.__exit__(None, None, None)
            rec.range = None
        if i == index:
            return


def _mark(name: str):
    opened = _open()
    if opened and _records[opened[-1]].mark:
        _end(opened[-1])
    _begin(name, True)


def _spans(first: int = 0) -> list:
    with _lock:
        return [Span(r.name, r.start, r.end,
                     r.parent - first if r.parent >= first else -1, r.tick,
                     dict(r.counts), r.profiled) for r in _records[first:]]


def spans() -> list:
    """Every span kept since the last :func:`reset`, in the order they
    opened (a parent before its children), as :class:`Span`."""
    return _spans()


@contextlib.contextmanager
def recording():
    """``with tracing.recording() as got: ...`` records the block alone:
    the recorder is on for it, and when the block ends ``got`` receives
    the spans it opened (as :func:`spans` would list them, a parent opened
    before the block counting as none), which are then dropped from the
    recorder, so it keeps what it kept before and is on or off as
    before. Spans that other threads open meanwhile go with them."""
    was_on = _ON
    with _lock:
        first = len(_records)
    got = []
    enable()
    try:
        yield got
    finally:
        if not was_on:
            disable()
        got.extend(_spans(first))
        with _lock:
            del _records[first:]


def counters() -> dict:
    """{name: total}: each host counter summed over the spans (and outside
    them), each device counter read to the host."""
    with _lock:
        out = dict(_outside)
        for r in _records:
            for k, v in r.counts.items():
                out[k] = out.get(k, 0) + v
        device = dict(_device)
    for k, v in device.items():
        out[k] = int(v)
    return out


def stage_seconds(kept: list, root: str) -> dict:
    """{name: [seconds of each run]} of the spans of ``kept`` (a
    :func:`spans` list) whose parent is a root span named ``root``."""
    out = {}
    for s in kept:
        if (s.parent >= 0 and kept[s.parent].parent < 0
                and kept[s.parent].name == root and s.end_ns is not None):
            out.setdefault(s.name, []).append((s.end_ns - s.start_ns) * 1e-9)
    return out


def clock_offset_ns(events, kept: list = None) -> tuple:
    """The recorder's clock against a profile's: over the profile's host
    ``span:<name>`` events (``prof.events()``), each matched to the span of
    that name opened under the profile in the same order, the median of
    the event's start (µs, the profile's clock) less the span's start.
    ``t_ns + offset`` is then in the profile's clock, in ns. Returns
    (offset, the largest gap in ns of a matched event's start or end from
    its span's after the offset), or (None, None) when no event
    matches."""
    kept = spans() if kept is None else kept
    by_name = {}
    for s in kept:
        if s.profiled:
            by_name.setdefault(s.name, []).append(s)
    seen, pairs = {}, []
    cpu = torch.autograd.DeviceType.CPU
    for e in sorted((e for e in events if e.name.startswith("span:")
                     and e.device_type == cpu),
                    key=lambda e: e.time_range.start):
        name = e.name[5:]
        k = seen.get(name, 0)
        seen[name] = k + 1
        mine = by_name.get(name, [])
        if k < len(mine):
            pairs.append((e.time_range, mine[k]))
    if not pairs:
        return None, None
    offset = float(np.median([r.start * 1e3 - s.start_ns
                              for r, s in pairs]))
    worst = max(max(abs(r.start * 1e3 - s.start_ns - offset),
                    abs(r.end * 1e3 - s.end_ns - offset)
                    if s.end_ns is not None else 0.0) for r, s in pairs)
    return offset, worst
