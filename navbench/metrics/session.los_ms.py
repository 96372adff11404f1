"""Mean ms a session tick spends in the long-edge LOS gate alone
(``planning/global_/planner.py``'s call of ``long_edge_los_mask``), over
the ticks that run it."""
from navbench import readers


def read(record):
    return readers.stage_ms(record, ["los"])
