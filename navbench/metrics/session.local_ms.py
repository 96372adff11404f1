"""Mean ms a session tick spends in the local tick: both generators and
``path_blocked`` (``MoveBaseDriver._local``)."""
from navbench import readers


def read(record):
    return readers.stage_ms(record, ["local"])
