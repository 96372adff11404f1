"""The fleet's MCL update as one CUDA graph per tick
(``parallel/fleet.py::fleet_localize`` through
``ops/cuda_graph.py::GraphedStep``), at the fleet cell's CPU cut
(``navbench/configs/fleet64.json`` with ``navbench/tiny/fleet64.json``).

Six ticks of a tour, each with its own draws and odometry drift, and two
of them forced: at tick 2 robot 0's previous expectation lies 3 m off, so
its filter jumps; at tick 4 robots 0 and 2 lie 50 m off the map, so no
feature matches and their filters expand. The cell's own expansion
threshold is 0 (no tick can expand), so these tests set one.

On the CPU: ``fleet_localize`` runs its eager body, which reads nothing
back to the host, gives what a direct ``mcl_update`` gives and leaves the
graph cache alone. On the card (marked ``cuda``, skipped without one): the
graph against the eager body, bit for bit. This file imports no JAX, so
the card can run it whole.
"""
import copy
import dataclasses
import json
import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dddmr_navigation_tpu_torch.geometry import quat_from_yaw, quat_multiply
from dddmr_navigation_tpu_torch.parallel import fleet
from dddmr_navigation_tpu_torch.rounding import fma_norm
from dddmr_navigation_tpu_torch.runtime import tracing
from dddmr_navigation_tpu_torch.state_estimation.likelihood import (
    build_submap_context)
from dddmr_navigation_tpu_torch.state_estimation.mcl import mcl_update
from dddmr_navigation_tpu_torch.state_estimation.pf import MCLDraws
from navbench import spec
from navbench.run import PROGRAM
from navbench.world import build_world

SEED = 2 ** 31 + 17
TICKS = 6
JUMP_TICK, JUMPERS = 2, [0]
EXPAND_TICK, EXPANDERS = 4, [0, 2]
MATCH_RATIO_THRESH = 0.02


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = (_merge(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else copy.deepcopy(v))
    return out


def _cell(device, sampling: str):
    """The fleet cell's CPU cut built on ``device`` (three robots, eight
    particles), and its MCL configuration with ``field_sampling`` set to
    ``sampling`` and an expansion threshold."""
    torch.set_num_threads(2)
    config = spec.load_config("fleet64")
    with open(os.path.join(spec.HERE, "tiny", "fleet64.json")) as f:
        config = _merge(config, json.load(f))
    params = _merge(spec.load_traffic("fleet64-open"), {"period_ticks": 48})
    world = build_world(config["map"])
    traffic = spec.load_generator(params["generator"])(
        world, config, params, SEED, device)
    built = spec.load_system(config["system"]).Built(
        PROGRAM, config, world, traffic, device)
    cfg = dataclasses.replace(built.mcl, field_sampling=sampling,
                              match_ratio_thresh=MATCH_RATIO_THRESH)
    return built, cfg, world


def _shift(x, robots, metres: float):
    d = torch.zeros_like(x)
    d[robots, ..., 0] = metres
    return x + d


def _tick(built, cfg, state, t: int):
    """Tick ``t``'s start state (the tour's true pose, the forced MCL
    state) and ``fleet_localize``'s keyword arguments."""
    tr = built.traffic
    m = state.mcl
    if t == JUMP_TICK:
        m = m._replace(state_prev_pos=_shift(m.state_prev_pos, JUMPERS, 3.0))
    elif t == EXPAND_TICK:
        m = m._replace(
            state_prev_pos=_shift(m.state_prev_pos, EXPANDERS, 50.0),
            particles=m.particles._replace(
                pos=_shift(m.particles.pos, EXPANDERS, 50.0)))
    state = state._replace(pos=tr.pos[t], quat=tr.quat[t], mcl=m)
    kw = dict(mcl_cfg=cfg, submap_ctx=built.submap,
              odom_drift_pos=tr.drift_pos[t], odom_drift_yaw=tr.drift_yaw[t],
              feature_map_pts=built.walls, feature_ground_pts=built.ground,
              mcl_draws=MCLDraws(**{k: v[t] for k, v in tr.draws.items()}),
              feature_keys_=built.keys)
    return state, kw


def _after(state, loc):
    return state._replace(mcl=loc.mcl, odom_prev_pos=loc.odom_pos,
                          odom_prev_quat=loc.odom_quat)


def _leaves(loc) -> tuple:
    return (*fleet._mcl_leaves(loc.mcl), *loc[1:])


def _body(built, state, kw) -> tuple:
    """The eager body's result from the tick's start state."""
    return fleet._localize_step(
        kw["mcl_cfg"], built.submap, built.walls, built.ground, built.keys,
        state.pos, state.quat, state.odom_prev_pos, state.odom_prev_quat,
        kw["odom_drift_pos"], kw["odom_drift_yaw"], built.traffic.dt,
        *fleet._mcl_leaves(state.mcl), *kw["mcl_draws"])


def _direct(built, state, kw):
    """The tick's update as one direct ``mcl_update`` call: (the leaves
    of the FleetLocalization it amounts to, MCLOutput)."""
    odom_pos = state.pos + kw["odom_drift_pos"]
    odom_quat = quat_multiply(state.quat, quat_from_yaw(kw["odom_drift_yaw"]))
    feats = fleet.device_features_from_map(
        built.walls, built.ground, state.pos, state.quat, keys=built.keys)
    mcl2, out = mcl_update(
        kw["mcl_cfg"], built.submap, state.mcl, state.odom_prev_pos,
        state.odom_prev_quat, odom_pos, odom_quat, built.traffic.dt, *feats,
        torch.ones(feats[2].shape[:2], device=state.pos.device),
        kw["mcl_draws"])
    loc = fleet.FleetLocalization(
        mcl2, odom_pos, odom_quat, out.pose_pos, out.pose_quat,
        fma_norm(out.pose_pos - state.pos), out.match_ratio_max)
    return _leaves(loc), out


def _check_forced(t: int, out):
    robots = out.jumped.shape[0]
    if t < JUMP_TICK:
        assert not out.jumped.any() and not out.expanded.any()
    if t == JUMP_TICK:
        assert out.jumped.tolist() == [r in JUMPERS for r in range(robots)]
    if t == EXPAND_TICK:
        assert not out.jumped.any()
        assert out.expanded.tolist() == [r in EXPANDERS
                                         for r in range(robots)]


def _equal(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _cache(graphs) -> tuple:
    return graphs.captures, graphs.replays, tuple(graphs._graphs)


class NoHostReads(TorchDispatchMode):
    """Fails on any op that reads a tensor back to the host."""

    READS = ("_local_scalar_dense", "item", "nonzero")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ in self.READS:
            raise AssertionError(f"host read: {func}")
        return func(*args, **(kwargs or {}))


def test_the_guard_catches_a_host_read():
    x = torch.arange(4.0)
    for read in (lambda: x.sum().item(), lambda: torch.nonzero(x),
                 lambda: float(x[1])):
        with pytest.raises(AssertionError, match="host read"):
            with NoHostReads():
                read()


@pytest.mark.parametrize("sampling", ["corr", "trilinear"])
def test_eager_localize_reads_nothing_back_and_is_mcl_update(sampling):
    built, cfg, _ = _cell("cpu", sampling)
    graphs = fleet.LOCALIZE_GRAPHS
    cache = _cache(graphs)
    state = built.state0
    for t in range(TICKS):
        state, kw = _tick(built, cfg, state, t)
        want, out = _direct(built, state, kw)
        _check_forced(t, out)
        with NoHostReads():
            loc = fleet.fleet_localize(state, built.traffic.dt, **kw)
        assert _equal(_leaves(loc), want)
        assert _equal(_body(built, state, kw), want)
        state = _after(state, loc)
    assert _cache(graphs) == cache


def test_without_mcl_the_true_pose_plans():
    built, _, _ = _cell("cpu", "corr")
    graphs = fleet.LOCALIZE_GRAPHS
    cache = _cache(graphs)
    state = built.state0
    loc = fleet.fleet_localize(state, built.traffic.dt)
    assert loc.mcl is state.mcl
    for got in (loc.odom_pos, loc.plan_pos):
        assert torch.equal(got, state.pos)
    for got in (loc.odom_quat, loc.plan_quat):
        assert torch.equal(got, state.quat)
    assert not loc.mcl_err.any() and not loc.match_ratio.any()
    assert _cache(graphs) == cache


# ---------------------------------------------------------------------------
# on the card: the graph against the eager body
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["corr", "trilinear"])
def test_localize_graph_matches_the_eager_body(cuda_device, sampling):
    built, cfg, world = _cell(cuda_device, sampling)
    graphs = fleet.LOCALIZE_GRAPHS
    c0, r0 = graphs.captures, graphs.replays
    mismatch, kept = [], []
    state = built.state0
    with tracing.recording():
        before = tracing.counters()
        for t in range(TICKS):
            state, kw = _tick(built, cfg, state, t)
            eager = _body(built, state, kw)
            want, out = _direct(built, state, kw)
            _check_forced(t, out)
            assert _equal(eager, want)
            loc = fleet.fleet_localize(state, built.traffic.dt, **kw)
            got = _leaves(loc)
            mismatch += [(t, i) for i, (a, b) in enumerate(zip(got, eager))
                         if not torch.equal(a, b)]
            kept.append((got, [x.clone() for x in got]))
            state = _after(state, loc)
        after = tracing.counters()
    assert mismatch == []
    # no later replay wrote into a result handed out before
    assert [t for t, (got, copy_) in enumerate(kept)
            if not _equal(got, copy_)] == []
    assert (graphs.captures - c0, graphs.replays - r0) == (1, TICKS - 1)
    counts = {k: v - before.get(k, 0) for k, v in after.items()}
    assert (counts.get("localize.graph_capture"),
            counts.get("localize.graph_replay")) == (1, TICKS - 1)
    # a new submap is a new graph, though its fields are equal
    built.submap = build_submap_context(world.structure, world.ground,
                                        built.mcl, device=cuda_device)
    state, kw = _tick(built, cfg, state, 0)
    loc = fleet.fleet_localize(state, built.traffic.dt, **kw)
    assert _equal(_leaves(loc), _body(built, state, kw))
    assert graphs.captures - c0 == 2
