"""Fixpoint iteration without a host read per iteration.

The JAX package runs its label propagation and wavefront relaxations as
``lax.while_loop``s that stop at the first iteration that changes nothing,
or at ``max_iters`` (`clustering.py:94`, `wavefront.py:185`, `:248`).
Here the loop runs in blocks of ``block`` iterations; the per-robot
"done" flags and iteration counts stay on the device, and the host reads
the flags once per block. The operators are idempotent at a fixpoint, so
the iterations a converged robot sits through change nothing, and a robot
that is done is frozen all the same (it may be done at ``max_iters``
without having converged). ``iters`` then equals the JAX loop's count
exactly. Each read of the flags counts as one ``host_reads`` of the
tracing recorder while it is on.
"""
from __future__ import annotations

import torch

from dddmr_navigation_tpu_torch.runtime import tracing


def iterate_to_fixpoint(step, x, max_iters: int, block: int = 16):
    """Apply ``step`` to ``x`` (leading robot axis B) until each robot's
    slice stops changing, at most ``max_iters`` times.

    Returns (x, iters (B,) int32): the iterations each robot ran, counting
    the one that changed nothing.
    """
    b = x.shape[0]
    expand = (slice(None),) + (None,) * (x.dim() - 1)
    iters = torch.zeros(b, dtype=torch.int32, device=x.device)
    done = torch.zeros(b, dtype=torch.bool, device=x.device)
    n = 0
    while n < max_iters:
        for _ in range(min(block, max_iters - n)):
            new = step(x)
            active = ~done
            iters += active
            changed = (new != x).flatten(1).any(dim=1)
            x = torch.where(active[expand], new, x)
            done = done | ~changed
            n += 1
        if tracing.on():
            tracing.count("host_reads")
        if bool(done.all()):
            break
    return x, iters
