"""Synthetic sensor simulation fixtures (the port's copy of
``dddmr_navigation_tpu/utils``)."""
from dddmr_navigation_tpu_torch.utils.lidar_sim import BoxWorld, simulate_scan
