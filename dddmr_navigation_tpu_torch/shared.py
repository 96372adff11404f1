"""The JAX package's framework-free modules, loaded without its packages.

``planning/global_/graph.py`` (``build_ground_graph``),
``perception/static_weights.py`` (``compute_node_weights``) and
``utils/lidar_sim.py`` (``BoxWorld``, ``simulate_scan``) import only numpy,
scipy and the framework-free config; but the ``__init__`` of each of their
packages imports JAX. :func:`load` reads such a file by path, as a module
of its own, so the port shares the code without copying it and without
importing JAX. ``dddmr_navigation_tpu.io`` and ``.config`` have
framework-free ``__init__``s and are imported normally.
"""
from __future__ import annotations

import functools
import importlib.util
import sys
from pathlib import Path

JAX_PACKAGE_DIR = Path(__file__).resolve().parent.parent / "dddmr_navigation_tpu"


@functools.cache
def load(relpath: str):
    """The module at ``dddmr_navigation_tpu/<relpath>``, executed once, under
    the name ``dddmr_navigation_tpu_torch.shared.<stem>``."""
    path = JAX_PACKAGE_DIR / relpath
    name = f"{__name__}.{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def build_ground_graph(*args, **kwargs):
    """``dddmr_navigation_tpu/planning/global_/graph.py::build_ground_graph``."""
    return load("planning/global_/graph.py").build_ground_graph(*args, **kwargs)


def compute_node_weights(*args, **kwargs):
    """``dddmr_navigation_tpu/perception/static_weights.py::compute_node_weights``."""
    return load("perception/static_weights.py").compute_node_weights(
        *args, **kwargs)


def lidar_sim():
    """``dddmr_navigation_tpu/utils/lidar_sim.py`` (``BoxWorld``,
    ``simulate_scan``)."""
    return load("utils/lidar_sim.py")
