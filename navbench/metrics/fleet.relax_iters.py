"""Relaxation iterations (the tick's ``wf_iters``), mean per robot-tick."""
from navbench import readers


def read(record):
    return readers.counter_mean(record, "relax_iters")
