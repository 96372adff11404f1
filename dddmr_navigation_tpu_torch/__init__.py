"""dddmr_navigation_tpu_torch — ``dddmr_navigation_tpu`` ported to
PyTorch, with hand-written CUDA kernels for an NVIDIA H100 (``sm_90a``):
the local-planner fleet tick, the fused perception → global replan →
local tick, the full-fidelity fleet tick and its sharded variants over
``torch.distributed``, the single-robot navigation session, the
localization vertical (pose-graph submaps, feature weights, odom3d,
global localization) and the SLAM vertical (mapping, loop closure, the
pose-graph editor).

The JAX package stays the reference. The port mirrors its module paths
(``geometry/``, ``ops/``, ``perception/``, ``planning/local/``,
``planning/global_/``, ``control/``, ``state_estimation/``, ``parallel/``,
``slam/``) and imports nothing of it, nor JAX: it keeps its own copies of
the framework-free config dataclasses (``config/``) and numpy-only modules
(``io/maps.py``, ``io/pcd.py``, ``io/occupancy.py``,
``planning/global_/graph.py``, ``perception/static_weights.py``,
``utils/lidar_sim.py``, the pose-graph files of
``state_estimation/submaps.py``). Entry points run on the card
unless given ``device="cpu"``. Every per-robot tensor has a leading robot
axis B; map tables are shared.
"""
