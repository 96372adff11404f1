"""Mean ms a fleet tick spends in ``fleet_decide`` (rotate generator,
recovery, FSM)."""
from navbench import readers


def read(record):
    return readers.stage_ms(record, ["fleet_decide"])
