"""dddmr_navigation_tpu_torch — the local-planner slice of
``dddmr_navigation_tpu`` ported to PyTorch, with hand-written CUDA kernels
for an NVIDIA H100 (``sm_90a``).

The JAX package stays the reference. The port mirrors its module paths
(``geometry/se3.py``, ``ops/``, ``planning/local/``, ``parallel/fleet.py``),
shares its framework-free config dataclasses (``dddmr_navigation_tpu.config``)
and never imports JAX. Every function on the tick takes a leading robot
axis B.
"""
