"""Traffic generators, one module each, found by the ``generator`` that a
traffic file names (``traffic/<mix>.json`` → ``generators/<name>.py``).

A generator's ``generate(world, config, params, seed, device)`` makes a
cell's inputs from ``--seed`` in set-up and returns a NamedTuple of
them (``tours.Traffic``, or a kind of its own): the system that the
configuration names reads its fields tick by tick, and the run's log
line lists them. A new kind of traffic is a new module here and a
traffic file that names it.
"""
