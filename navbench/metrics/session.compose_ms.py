"""Mean ms a session tick spends in the composition: ``min_dgraph`` and
the lethal cloud (``NavigationSession._compose``)."""
from navbench import readers


def read(record):
    return readers.stage_ms(record, ["compose"])
