"""The collision kernel's share of its roofline in the session ticks (bound:
navbench.bounds)."""
from navbench import readers


def read(record):
    return readers.roofline_pct(record, "swept_box_hits")
