"""Drives a fleet deployment through ``parallel/fleet.py::fleet_full_tick``:
MCL, perception, one relaxation for the fleet, extraction, the simple and
rotate generators, the FSM and the recovery, for every robot each tick.

The same code builds the program (``dddmr_navigation_tpu_torch``) and the
reference (``navbench.reference``, the frozen plain copy): both expose
the same modules, and each builds its own map tables and start state from
the benchmark's world. Each tick, the benchmark forces the true pose and
twist of its tour into the state and hands the tick the tour's sweep,
goal, drift and MCL draws.
"""
from __future__ import annotations

import importlib

import torch

from navbench.spec import build_dataclass


# The modules of a side that the deployment calls.
MODULES = ("config", "control.fused", "parallel.fleet",
           "state_estimation.likelihood")


class Built:
    """One side's configuration, map tables and start state."""

    def __init__(self, pkg: str, config: dict, world, traffic, device):
        self.pkg = pkg
        mods = {m: importlib.import_module(f"{pkg}.{m}") for m in MODULES}
        self.mods = mods
        c = mods["config"]
        self.cfg = build_dataclass(c.NavigationConfig(), config["navigation"])
        self.mb = build_dataclass(c.MoveBaseConfig(), config["move_base"])
        self.mcl = build_dataclass(c.MCLConfig(), config["mcl"])
        fused, fleet = mods["control.fused"], mods["parallel.fleet"]
        self.fmap = fused.build_fused_map(self.cfg, world.ground,
                                          world.structure, device=device)
        self.submap = mods["state_estimation.likelihood"].build_submap_context(
            world.structure, world.ground, self.mcl, device=device)
        _, self.spec, self.ri, self.params = fused.make_fused_tick(self.cfg)
        self.walls = torch.as_tensor(world.structure, device=device)
        self.ground = torch.as_tensor(world.ground, device=device)
        self.keys = (fleet.feature_keys(len(world.structure), device),
                     fleet.feature_keys(len(world.ground), device))
        self.offset = torch.as_tensor(config["sensor"]["offset"],
                                      dtype=torch.float32, device=device)
        self.traffic = traffic
        self.draw_type = importlib.import_module(
            f"{pkg}.state_estimation.pf").MCLDraws
        self.state0 = fleet.init_fleet_full_state(
            self.cfg, len(world.ground), traffic.pos[0].cpu().numpy(),
            traffic.quat[0].cpu().numpy(), mcl_cfg=self.mcl,
            mcl_normals=traffic.init_normals, device=device)


def tick(b: Built, state, t: int):
    """Tick ``t`` from ``state``. Returns (state, record): the record's
    ``diag`` is the tick's diag dict, ``cmd`` its (B, 2) commands. The
    tick is looked up in its module at each call, so a wrapper put there
    (a fault in a test) is the one that runs."""
    tr = b.traffic
    p = t % tr.period
    state = state._replace(pos=tr.pos[p], quat=tr.quat[p], v=tr.v[p],
                           w=tr.w[p])
    draws = b.draw_type(**{k: v[p] for k, v in tr.draws.items()})
    fleet = b.mods["parallel.fleet"]
    state2, diag = fleet.fleet_full_tick(
        b.cfg, b.mb, b.spec, b.ri, b.params, b.fmap, state, tr.scans[p],
        tr.masks[p], b.offset, tr.goals[p], tr.now[t], tr.dt,
        mcl_cfg=b.mcl, submap_ctx=b.submap, odom_drift_pos=tr.drift_pos[p],
        odom_drift_yaw=tr.drift_yaw[p], feature_map_pts=b.walls,
        feature_ground_pts=b.ground, mcl_draws=draws, feature_keys_=b.keys)
    return state2, {"diag": diag,
                    "cmd": torch.stack([diag["vx"], diag["wz"]], dim=1)}
