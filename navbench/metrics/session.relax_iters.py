"""Relaxation iterations a session tick runs: its plan queries' and DWA
window replans' together (0 in a tick that plans nothing)."""
from navbench import readers


def read(record):
    return readers.counter_mean(record, "relax_iters")
