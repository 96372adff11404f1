"""The global planner's successor-table walk, batched over robots.

Counterpart of the JAX package's ``lax.scan`` over the successor table in
``dddmr_navigation_tpu/planning/global_/wavefront.py`` (the greedy-descent
walk of its extraction; no Pallas kernel).

``walk_table`` dispatches on the tensors' device: CPU tensors go to
:func:`walk_table_plain`, CUDA tensors to the hand-written kernel in
``csrc/walk_table.cu`` (one launch a call); anything else raises. The walk
is integers only, so the two agree bit for bit.
"""
from __future__ import annotations

import torch

from dddmr_navigation_tpu_torch.ops._launch import (
    check_cuda_inputs, launch, raise_unless_cpu)
from dddmr_navigation_tpu_torch.runtime import tracing

# The kernel keeps a walk's nodes in shared memory, 8 B a slot (32 KB at
# this length), within the 48 KB a block may take without opting in.
MAX_LEN = 4096


def walk_table_plain(succ, stuck, e0, stuck0, node_of, start_idx, goal_idx,
                     max_len: int):
    """Plain PyTorch version. Same arguments as :func:`walk_table`.

    Terminal states (stuck, or at the goal) are rewritten to self-loops,
    then the walk is one table gather per step; validity, length and the
    final node come afterwards from the state sequence, as the JAX version
    recovers them."""
    b, s = succ.shape
    term = stuck | (node_of == goal_idx[:, None])
    succ2 = torch.where(term, torch.arange(s, device=succ.device), succ)
    e = e0[:, None]
    states = [e]
    for _ in range(max_len - 2):
        e = succ2.gather(1, e)
        states.append(e)
    es = torch.cat(states, dim=1)                                # (B, L-1)
    idxs_raw = torch.cat([start_idx[:, None], node_of[es]], dim=1)
    flags = torch.cat([((start_idx == goal_idx) | stuck0)[:, None],
                       (idxs_raw[:, 1:] == goal_idx[:, None])
                       | stuck.gather(1, es)], dim=1)
    done_before = torch.cat([
        torch.zeros((b, 1), dtype=torch.bool, device=succ.device),
        torch.cumsum(flags.int(), dim=1)[:, :-1] > 0], dim=1)
    valids = ~done_before
    length = valids.sum(dim=1)
    stop = torch.clamp(torch.argmax(flags.int(), dim=1), max=max_len - 1)
    final = torch.where(flags.any(dim=1),
                        idxs_raw.gather(1, stop[:, None])[:, 0],
                        idxs_raw[:, max_len - 1])
    idxs = torch.where(valids, idxs_raw, final[:, None])
    return idxs, valids, length, final


def walk_table(succ, stuck, e0, stuck0, node_of, start_idx, goal_idx,
               max_len: int):
    """The greedy-descent walk over per-robot successor tables: from the
    start, the state after its first hop, then ``succ`` until a terminal
    state (stuck, or at the goal) or ``max_len`` nodes.

    Args:
      succ, stuck: (B, S) successor table and no-continuation flags
        (int64, bool); S = G for node tables, G·K for edge tables.
      e0, stuck0: (B,) state after the start's first hop, and whether that
        hop was impossible (int64, bool).
      node_of: (S,) node emitted on arrival in each state (int64).
      start_idx, goal_idx: (B,) int64.
      max_len: slots of the walk, at least 2 (at most :data:`MAX_LEN` on
        the card).

    Returns (idxs (B, L) int64, valids (B, L) bool, length (B,) int64,
    final (B,) int64): past the stop each slot holds the final node and is
    not valid.
    """
    if succ.device.type != "cuda":
        raise_unless_cpu(succ)
        return walk_table_plain(succ, stuck, e0, stuck0, node_of, start_idx,
                                goal_idx, max_len)
    return _launch_walk(succ, stuck, e0, stuck0, node_of, start_idx,
                        goal_idx, max_len)


walk_table.launches = 0


def _launch_walk(succ, stuck, e0, stuck0, node_of, start_idx, goal_idx,
                 max_len):
    b, s = succ.shape
    if not 2 <= max_len <= MAX_LEN:
        raise ValueError(f"max_len {max_len} outside [2, {MAX_LEN}]")
    check_cuda_inputs(
        (succ, (b, s), torch.int64),
        (stuck, (b, s), torch.bool),
        (e0, (b,), torch.int64),
        (stuck0, (b,), torch.bool),
        (node_of, (s,), torch.int64),
        (start_idx, (b,), torch.int64),
        (goal_idx, (b,), torch.int64))
    dev = succ.device
    idxs = torch.empty((b, max_len), dtype=torch.int64, device=dev)
    valids = torch.empty((b, max_len), dtype=torch.bool, device=dev)
    length = torch.empty((b,), dtype=torch.int64, device=dev)
    final = torch.empty((b,), dtype=torch.int64, device=dev)
    launch("walk_table_launch", succ, stuck.view(torch.uint8), e0,
           stuck0.view(torch.uint8), node_of, start_idx, goal_idx, b, s,
           max_len, idxs, valids.view(torch.uint8), length, final)
    walk_table.launches += 1
    if tracing.on():
        tracing.count("walk.kernel")
    return idxs, valids, length, final
