"""The device's idle share of the profiled session ticks: 100 − the union
of kernel intervals."""
from navbench import readers


def read(record):
    return readers.device_idle_pct(record)
