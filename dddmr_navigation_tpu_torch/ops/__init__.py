"""The port's three hand-written Hopper kernels, each with its plain PyTorch
version beside it:

  * ``swept_box_hits`` — the collision critic's oriented-cuboid sweep over
    (robots × samples × steps × obstacles), ``csrc/swept_box_hits.cu``;
  * ``masked_min_distance`` — the nearest-plan-point distance of the
    stick-path and toward-plan critics, ``csrc/masked_min_distance.cu``;
  * ``walk_table`` — the global planner's successor-table walk, one launch
    an extraction, ``csrc/walk_table.cu``.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
(built by :mod:`.build` at first use) or raises. Each wrapper counts its
launches in its ``launches`` attribute.
"""
from dddmr_navigation_tpu_torch.ops.collision import (
    swept_box_hits, swept_box_hits_plain)
from dddmr_navigation_tpu_torch.ops.distance_field import (
    masked_min_distance, masked_min_distance_plain)
from dddmr_navigation_tpu_torch.ops.walk import walk_table, walk_table_plain
