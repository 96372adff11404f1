"""Mean ms a fleet tick spends in ``fleet_perceive`` (perception:
mark/clear, composition, planner preparation)."""
from navbench import readers


def read(record):
    return readers.stage_ms(record, ["fleet_perceive"])
