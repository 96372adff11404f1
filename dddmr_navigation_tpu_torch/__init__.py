"""dddmr_navigation_tpu_torch — the local-planner fleet tick and the fused
perception → global replan → local tick of ``dddmr_navigation_tpu``
ported to PyTorch, with hand-written CUDA kernels for an NVIDIA H100
(``sm_90a``).

The JAX package stays the reference. The port mirrors its module paths
(``geometry/``, ``ops/``, ``perception/``, ``planning/local/``,
``planning/global_/``, ``control/fused.py``, ``parallel/fleet.py``) and
imports nothing of it, nor JAX: it keeps its own copies of the
framework-free config dataclasses (``config/``) and numpy-only modules
(``io/maps.py``, ``planning/global_/graph.py``,
``perception/static_weights.py``, ``utils/lidar_sim.py``). Entry points
run on the card unless given ``device="cpu"``. Every per-robot tensor has
a leading robot axis B; map tables are shared.
"""

