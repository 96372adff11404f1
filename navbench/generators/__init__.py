"""Traffic generators, one module each, found by the ``generator`` that a
traffic file names (``traffic/<mix>.json`` → ``generators/<name>.py``).

A generator's ``generate(world, config, params, seed, device)`` makes a
cell's inputs from ``--seed`` in set-up and returns a
:class:`navbench.generators.tours.Traffic`: the systems under
``systems/`` read its fields tick by tick. A new kind of traffic is a new
module here and a traffic file that names it.
"""
