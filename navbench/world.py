"""The benchmark's own worlds: the map a configuration deploys on (ground
nodes and static structure, as numpy) and the boxes its lidar sees.

Map clouds come from the frozen copy of the port's map generators
(``navbench.reference.io.maps``), so the yardstick's world does not move
when the program's generators do. A configuration's ``map`` entry names a
``kind`` below and its parameters.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from navbench.reference.io import maps


class World(NamedTuple):
    ground: np.ndarray        # (G, 3) ground nodes
    structure: np.ndarray     # (M, 3) static map cloud (walls, overhangs)
    boxes: np.ndarray         # (S, 2, 3) static boxes the lidar sees
    levels: tuple             # floor heights robots drive on
    regions: np.ndarray       # (L, 2, 2) xy rectangle of each level's floor


def _box(center, size):
    c, s = np.asarray(center, np.float32), np.asarray(size, np.float32)
    lo = c - np.asarray([s[0] / 2, s[1] / 2, 0.0], np.float32)
    return np.stack([lo, lo + s])


def lidar_boxes(p: dict) -> np.ndarray:
    """(S, 2, 3) static boxes given by their corners."""
    return np.asarray([[b["min"], b["max"]] for b in p.get("lidar_boxes", [])],
                      np.float32).reshape(-1, 2, 3)


def warehouse(p: dict) -> World:
    """A flat floor with wall boxes: each wall is both a map cloud (its
    points at ``wall_resolution``) and a box the lidar hits."""
    sx, sy = p["floor"]
    ground = maps.flat_ground_map(sx, sy, p["resolution"])
    walls = [maps.box_obstacle(w["center"], size=w["size"],
                               resolution=p["wall_resolution"])
             for w in p["walls"]]
    boxes = np.concatenate([np.stack([_box(w["center"], w["size"])
                                      for w in p["walls"]]),
                            lidar_boxes(p)])
    inner = np.asarray(p["free_region"], np.float32)
    return World(ground, np.concatenate(walls).astype(np.float32), boxes,
                 (0.0,), inner[None])


def multi_level(p: dict) -> World:
    """The port's two stacked floors joined by a ramp, with a low duct
    over floor A. The lidar sees the floor plane at z = 0 and the
    ``lidar_boxes``; returns from another level are masked with the
    ground (see :mod:`navbench.generators.tours`)."""
    ground, structure = maps.multi_level_map(resolution=p["resolution"])
    floor = np.asarray(p["free_region"], np.float32)
    return World(ground, structure, lidar_boxes(p),
                 tuple(p["levels"]), np.stack([floor] * len(p["levels"])))


KINDS = {"warehouse": warehouse, "multi_level": multi_level}


def build_world(map_params: dict) -> World:
    return KINDS[map_params["kind"]](map_params)
