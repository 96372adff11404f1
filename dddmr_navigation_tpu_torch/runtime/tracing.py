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
"""
from __future__ import annotations

import contextlib
import os
import time

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
