"""First-k true-index compaction, batched over a leading axis.

Counterpart of ``dddmr_navigation_tpu/ops/compaction.py``: ``torch.topk``
over the negated index, as the JAX version rides ``lax.top_k``. The scores
are unique (one per index), so the result is deterministic and equals
``nonzero``'s ascending order exactly. ``torch.nonzero`` would give the
same indices but reads its count back to the host on every call.
"""
from __future__ import annotations

import torch


def first_k_true_indices(mask, k: int):
    """Indices of the first ``k`` True entries along the last axis of
    ``mask`` (..., n), ascending, padded with -1: (..., k) int64."""
    n = mask.shape[-1]
    kk = min(k, n)
    iota = torch.arange(n, dtype=torch.int64, device=mask.device)
    score = torch.where(mask, -iota, -n - 1)
    idx = -torch.topk(score, kk, dim=-1).values
    idx = torch.where(idx > n - 1, -1, idx)
    if kk < k:
        pad = torch.full((*idx.shape[:-1], k - kk), -1, dtype=idx.dtype,
                         device=idx.device)
        idx = torch.cat([idx, pad], dim=-1)
    return idx
