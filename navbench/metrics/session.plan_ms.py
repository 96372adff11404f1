"""Mean ms a session tick spends in the plan manager, with the DWA
recompute and the LOS gate (``MoveBaseDriver._plan``)."""
from navbench import readers


def read(record):
    return readers.stage_ms(record, ["plan"])
