"""Mean ms a session tick spends in the depth-camera layer: buffering
the frames and its update (``NavigationSession._depth``)."""
from navbench import readers


def read(record):
    return readers.stage_ms(record, ["depth"])
