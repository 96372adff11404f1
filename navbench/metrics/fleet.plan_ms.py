"""Mean ms a fleet tick spends in ``fleet_relax`` and ``fleet_extract``
(the global planner)."""
from navbench import readers


def read(record):
    return readers.stage_ms(record, ["fleet_relax", "fleet_extract"])
