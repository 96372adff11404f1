"""Mean ms a fused tick spends in ``fused_pre_plan`` (perception,
composition, planner preparation)."""
from navbench import readers


def read(record):
    return readers.stage_ms(record, ["fused_pre_plan"])
