"""Cells cut to a CPU test's size: the same files, smaller numbers.

The tests here run on the CPU (the kernels take their plain versions
there); those that need the card carry the ``cuda`` marker and decide in
a fixture whether there is one.
"""
from __future__ import annotations

import copy

import pytest
import torch

from navbench.spec import Cell, load_benchmark

TINY = {
    "fleet64": {
        "robots": 3,
        "sensor": {"rings": 8, "cols": 32},
        "navigation": {
            "perception": {"lidar": {"max_scan_points": 256},
                           "voxel_window_cells_xy": 32,
                           "voxel_window_cells_z": 12,
                           "max_marked_voxels": 128,
                           "max_window_nodes": 1024},
            "local_planner": {"generator": {"linear_x_sample": 4,
                                            "angular_z_sample": 4,
                                            "max_num_steps": 8},
                              "max_obstacle_points": 64,
                              "collision_near_k": 16},
            "global_planner": {"max_relax_iters": 64,
                               "max_long_edges": 32}},
        "mcl": {"num_particles": 8},
    },
    "robot8k": {
        "sensor": {"rings": 8, "cols": 64},
        "navigation": {
            "perception": {"lidar": {"max_scan_points": 512,
                                     "range_image_rows": 8,
                                     "range_image_cols": 64},
                           "voxel_window_cells_xy": 32,
                           "voxel_window_cells_z": 16},
            "local_planner": {"generator": {"linear_x_sample": 4,
                                            "angular_z_sample": 8,
                                            "max_num_steps": 8},
                              "max_obstacle_points": 128,
                              "collision_near_k": 16},
            "global_planner": {"max_relax_iters": 96}},
    },
}
TINY_TRAFFIC = {"period_ticks": 48, "warmup_ticks": 1,
                "check": {"chain_ticks": 2, "forced_ticks": 2, "below": 6},
                "trace": {"profile_ticks": 1, "sync_ticks": 1}}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else copy.deepcopy(v))
    return out


def tiny_cell(workload: str) -> Cell:
    """The benchmark's cell ``workload`` cut to a CPU test's size."""
    torch.set_num_threads(2)
    cell = Cell(load_benchmark(), workload)
    cell.config = _merge(cell.config, TINY[cell.entry["config"]])
    cell.traffic = _merge(cell.traffic, TINY_TRAFFIC)
    return cell


@pytest.fixture
def cuda_device():
    """The card, or a skip when there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
