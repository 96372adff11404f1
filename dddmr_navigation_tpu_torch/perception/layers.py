"""Layer composition (counterpart of the ``min_dgraph`` of
``dddmr_navigation_tpu/perception/layers.py``). The path-blocked, speed-zone
and no-entry layers are not ported yet."""
from __future__ import annotations

import torch


def min_dgraph(*dgraphs):
    """`StackedPerception::get_min_dGraphValue`
    (`stacked_perception.cpp:114-126`): the elementwise min over layers."""
    out = dgraphs[0]
    for d in dgraphs[1:]:
        out = torch.minimum(out, d)
    return out
