"""Mean ms a session tick spends in the FSM and the tick's one device
read (``MoveBaseDriver._decide``)."""
from navbench import readers


def read(record):
    return readers.stage_ms(record, ["fsm"])
