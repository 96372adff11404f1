"""The benchmark's plain reference: a frozen copy of the plain path of
``dddmr_navigation_tpu_torch`` (the fleet tick of ``parallel/fleet.py``,
the fused tick of ``control/fused.py`` and every module they reach), with
the two hand-written kernels replaced by their plain PyTorch versions.

It imports nothing of the program. A change to the program leaves it as
it is, so the program's outputs are held to what this copy computes from
the same inputs, each compared number within the limit its
configuration gives; it builds its own map tables and start state. It is
a snapshot of the program, so it repeats any fault the program had when
it was copied: the program's tests against the JAX package check the
algorithm itself.
"""
