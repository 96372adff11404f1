"""Device kernels a session tick launches, from the profiler."""
from navbench import readers


def read(record):
    return readers.launches_per_tick(record)
