"""A step of fixed-shape tensor ops, replayed as a CUDA graph.

A step whose ops are many small kernels spends its time on the host
issuing them, one launch each. :class:`GraphedStep` captures the step once
per key (its inputs' shapes, dtypes and device, and whatever the caller
says the step's other arguments are) and replays the captured graph on
later calls: the host issues the copies of the inputs into the graph's
buffers, one graph launch and the clones of its outputs. The step must
make no host read and no host-to-device copy (capture raises on either),
so its constants live on the device already.

A capture first runs the step once eagerly on a side stream (which also
builds what the ops cache on first use, such as a device constant), and
that run's outputs are the first call's result. Each later call returns
clones of the graph's outputs, never its buffers, so a result kept from
one call is not overwritten by the next.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple

import torch

from dddmr_navigation_tpu_torch.runtime import tracing


class _Captured(NamedTuple):
    inputs: list              # the graph's input buffers
    graph: torch.cuda.CUDAGraph
    outputs: tuple            # the graph's output buffers
    keep: object              # what the graph reads besides its inputs


class GraphedStep:
    """``step(fn, key, tensors, keep)`` runs ``fn(*tensors)`` (CUDA tensors
    in, a tuple of tensors out) from the graph captured under ``key`` and
    the tensors' shapes, dtypes and device, capturing it on the first call.
    ``keep`` is held as long as the graph is (the tensors it reads besides
    its inputs, such as a map). At most ``MAX_GRAPHS`` graphs are kept,
    the least recently used dropped first.

    ``captures`` and ``replays`` count the calls of each kind; while the
    recorder is on they also count as ``<name>.graph_capture`` and
    ``<name>.graph_replay``."""

    MAX_GRAPHS = 8

    def __init__(self, name: str):
        self.name = name
        self.captures = 0
        self.replays = 0
        self._graphs = OrderedDict()
        self._lock = threading.Lock()

    def __call__(self, fn, key, tensors, keep=None) -> tuple:
        key = (key, tuple((t.shape, t.dtype, t.device) for t in tensors))
        with self._lock:
            got = self._graphs.get(key)
            if got is None:
                return self._capture(fn, key, tensors, keep)
            self._graphs.move_to_end(key)
            for buf, t in zip(got.inputs, tensors):
                buf.copy_(t)
            got.graph.replay()
            self.replays += 1
            if tracing.on():
                tracing.count(self.name + ".graph_replay")
            return tuple(t.clone() for t in got.outputs)

    def _capture(self, fn, key, tensors, keep) -> tuple:
        with torch.cuda.device(tensors[0].device):
            inputs = [t.clone(memory_format=torch.contiguous_format)
                      for t in tensors]
            here = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(here)
            with torch.cuda.stream(side):
                first = fn(*inputs)
            here.wait_stream(side)
            for t in first:
                t.record_stream(here)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = fn(*inputs)
        self._graphs[key] = _Captured(inputs, graph, outputs, keep)
        while len(self._graphs) > self.MAX_GRAPHS:
            self._graphs.popitem(last=False)
        self.captures += 1
        if tracing.on():
            tracing.count(self.name + ".graph_capture")
        return tuple(first)
