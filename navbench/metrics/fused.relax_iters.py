"""Relaxation iterations (``wf_iters``) a fused tick runs."""
from navbench import readers


def read(record):
    return readers.counter_mean(record, "relax_iters")
