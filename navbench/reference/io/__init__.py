"""Synthetic map generators (a frozen copy of the port's ``io/maps.py``)."""
