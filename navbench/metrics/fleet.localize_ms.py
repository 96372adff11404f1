"""Mean ms a fleet tick spends in ``fleet_localize`` (state estimation:
MCL)."""
from navbench import readers


def read(record):
    return readers.stage_ms(record, ["fleet_localize"])
