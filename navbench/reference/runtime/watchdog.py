"""The port's own copy of ``dddmr_navigation_tpu/runtime/watchdog.py``
(framework-free).

Failure detection + tick accounting — the compute-level watchdog
SURVEY.md §5 specs (the reference's robot-level gates live in the planner:
sensor freshness ⇒ PERCEPTION_MALFUNCTION, TF age ⇒ TF_FAIL; its only
compute observability is gettimeofday deadline warnings,
`local_planner.cpp:592-594` / `perception_3d_ros.cpp:243-247`).

Provides:
  * :class:`FreshnessGate` — per-source staleness checks
    (`Sensor::isCurrent` semantics, `multilayer_spinning_lidar.cpp:846-855`).
  * :class:`TickMonitor` — per-tick wall-clock accounting with p50/p99
    against a budget (the 20 Hz / 50 ms target from BASELINE.json) and
    deadline-miss counting.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class FreshnessGate:
    """Tracks last-update wall times per named source; ``ok()`` is the
    AND over sources (StackedPerception::isSensorOK)."""
    expected_dt: dict  # name -> max allowed age (s)
    _last: dict = field(default_factory=dict)

    def update(self, name: str, now: float | None = None):
        self._last[name] = time.monotonic() if now is None else now

    def is_current(self, name: str, now: float | None = None) -> bool:
        now = time.monotonic() if now is None else now
        last = self._last.get(name)
        return last is not None and (now - last) <= self.expected_dt[name]

    def ok(self, now: float | None = None) -> bool:
        return all(self.is_current(n, now) for n in self.expected_dt)


@dataclass
class TickMonitor:
    """Rolling tick-latency stats vs a budget."""
    budget_ms: float = 50.0
    window: int = 512
    _samples: list = field(default_factory=list)
    deadline_misses: int = 0
    ticks: int = 0
    _t0: float | None = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        assert self._t0 is not None, "start() not called"
        ms = (time.perf_counter() - self._t0) * 1e3
        self._t0 = None
        self.ticks += 1
        if ms > self.budget_ms:
            self.deadline_misses += 1
        self._samples.append(ms)
        if len(self._samples) > self.window:
            self._samples = self._samples[-self.window:]
        return ms

    def stats(self) -> dict:
        s = np.asarray(self._samples) if self._samples else np.zeros(1)
        return {
            "ticks": self.ticks,
            "p50_ms": float(np.percentile(s, 50)),
            "p99_ms": float(np.percentile(s, 99)),
            "max_ms": float(s.max()),
            "deadline_misses": self.deadline_misses,
            "budget_ms": self.budget_ms,
        }
