"""Mean ms a fused tick spends in ``fused_relax`` and ``fused_finish`` (the
global planner)."""
from navbench import readers


def read(record):
    return readers.stage_ms(record, ["fused_relax", "fused_finish"])
