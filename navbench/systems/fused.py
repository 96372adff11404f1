"""Drives a single-robot deployment through ``control/fused.py::fused_tick``
(perception → composition and planner preparation → relaxation →
extraction → interpolation and the local tick), as ``make_fused_tick``
builds it.

The same code builds the program (``dddmr_navigation_tpu_torch``) and the
reference (``navbench.reference``): each builds its own map tables (the
ground graph, the static node weights, the turning tables) and start
state from the benchmark's world. Each tick the benchmark hands the tick
the tour's true pose and twist, sweep and goal.
"""
from __future__ import annotations

import importlib

import torch

from navbench.spec import build_dataclass


# The modules of a side that the deployment calls.
MODULES = ("config", "control.fused", "perception.static_weights")


class Built:
    """One side's configuration, map tables and start state."""

    def __init__(self, pkg: str, config: dict, world, traffic, device):
        self.pkg = pkg
        self.mods = {m: importlib.import_module(f"{pkg}.{m}")
                     for m in MODULES}
        c, fused = self.mods["config"], self.mods["control.fused"]
        self.cfg = build_dataclass(c.NavigationConfig(), config["navigation"])
        weights, static_dgraph = self.mods[
            "perception.static_weights"].compute_node_weights(
                world.ground, world.structure)
        self.fmap = fused.build_fused_map(
            self.cfg, world.ground, world.structure, node_weight=weights,
            static_dgraph=static_dgraph, device=device)
        _, self.spec, self.ri, self.params = fused.make_fused_tick(self.cfg)
        self.offset = torch.as_tensor(config["sensor"]["offset"],
                                      dtype=torch.float32, device=device)
        self.traffic = traffic
        self.state0 = fused.init_fused_state(self.cfg, len(world.ground),
                                             traffic.pos[0])


def tick(b: Built, state, t: int):
    """Tick ``t`` from ``state``. Returns (state, record): the record's
    ``out`` is the tick's FusedOut, ``cmd`` its (B, 2) commands. The tick
    is looked up in its module at each call, so a wrapper put there (a
    fault in a test) is the one that runs."""
    tr = b.traffic
    p = t % tr.period
    fused = b.mods["control.fused"]
    state2, out = fused.fused_tick(
        b.cfg, b.spec, b.ri, b.params, "differential_drive_simple", b.fmap,
        state, tr.scans[p], tr.masks[p], tr.pos[p], tr.quat[p], b.offset,
        tr.goals[p], tr.v[p], tr.w[p])
    return state2, {"out": out,
                    "cmd": torch.stack([out.vx, out.wz], dim=1)}
