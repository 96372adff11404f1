"""Mean ms a fused tick spends in ``fused_post_plan`` (interpolation and
the local planner)."""
from navbench import readers


def read(record):
    return readers.stage_ms(record, ["fused_post_plan"])
