"""Mean ms a fleet tick spends in ``fleet_simple_local`` (the local
planner)."""
from navbench import readers


def read(record):
    return readers.stage_ms(record, ["fleet_simple_local"])
