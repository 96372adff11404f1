"""Host syncs a session tick makes, from CUDA's sync debug mode."""
from navbench import readers


def read(record):
    return readers.syncs_per_tick(record)
