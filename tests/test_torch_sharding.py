"""The port's sharded fleet ticks (``parallel/fleet.py``,
``parallel/multihost.py``) on the CPU, over gloo groups of 2 and 4
processes, against the port's unsharded ticks and the JAX package's
``shard_map`` ticks over its 8-device CPU mesh (``tests/test_multihost.py``
and ``__graft_entry__.dryrun_multichip``'s inputs and shapes), as
``tools/make_sharding_golden.py`` records them in
``testdata/sharding_golden.npz`` (the fused and full JAX ticks take
minutes to compile); the local tick is also run live.

The ranks are spawned processes running :func:`_rank_worker`, which
imports nothing of JAX (the test functions import it); every rank joins
``init_process_group`` with a timeout, each process is joined with one,
and a rank still alive then is killed and fails the test.

Tolerances: each rank's outputs are bit-equal to the unsharded port
tick's slice of them; against JAX, integer outputs (state codes,
decisions, plan_ok) and the reduced robot counts are exact, floats within
rtol 2e-6 (the fleet's), the reduced mean cost within rtol 2e-6.
"""
import datetime
import multiprocessing
import os
import socket
import sys

import numpy as np
import pytest
import torch

from tools.make_sharding_golden import (
    FULL_B, FULL_DIAG, FULL_TICKS, FUSED_B, LOCAL_B, full_setup, fused_setup,
    jax_local, local_setup)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                      "sharding_golden.npz")
JOIN_S = 150.0               # each rank's whole run, at most
PG_TIMEOUT_S = 60.0          # init_process_group and every collective
FULL_INT = ("decision", "cmd_source", "ps_simple", "ps_rotate", "plan_ok")


# ---------------------------------------------------------------------------
# the port's ticks: unsharded (mesh None) or over this rank's block
# ---------------------------------------------------------------------------

def _np(x):
    return x.detach().cpu().numpy()


def port_local(mesh=None, multihost=False):
    """(vx, wz, codes, costs, mean cost or None) of the local tick."""
    from dddmr_navigation_tpu_torch import config as C
    from dddmr_navigation_tpu_torch.parallel import fleet, multihost as mh
    from dddmr_navigation_tpu_torch.planning.local.planner import (
        make_global_plan)
    cfg, x = local_setup(C)
    b = x["plan"].shape[0]
    plans = make_global_plan(x["plan"], max_len=cfg.max_plan_len,
                             device="cpu")
    state = fleet.FleetState(
        pos=torch.zeros((b, 3)),
        quat=torch.tensor([[0.0, 0.0, 0.0, 1.0]]).repeat(b, 1),
        v=torch.zeros((b,)), w=torch.zeros((b,)))
    args = (plans, state, torch.as_tensor(x["obstacles"]),
            torch.as_tensor(x["obs_valid"]))
    if mesh is None:
        cmd = fleet.fleet_tick(cfg, *args)
        return [_np(v) for v in (cmd.vx, cmd.wz, cmd.state, cmd.best_cost)]
    if multihost:
        args = mh.host_local_batch(mesh, fleet.shard_fleet_arrays(mesh, args))
        return [_np(v) for v in mh.sharded_fleet_tick_multihost(cfg, mesh)(
            *args)]
    args = fleet.shard_fleet_arrays(mesh, args)
    return [_np(v) for v in fleet.sharded_fleet_tick(cfg, mesh)(*args)]


def port_fused(mesh=None):
    """(vx, wz, codes, plan_ok, found or None) of the fused tick."""
    from dddmr_navigation_tpu_torch import config as C
    from dddmr_navigation_tpu_torch.control.fused import (
        build_fused_map, init_fused_state, make_fused_tick)
    from dddmr_navigation_tpu_torch.io import maps as M
    from dddmr_navigation_tpu_torch.parallel import fleet
    cfg, x = fused_setup(C, M)
    fmap = build_fused_map(cfg, x["ground"], device="cpu")
    _, spec, ri, params = make_fused_tick(cfg)
    t = {k: torch.as_tensor(v) for k, v in x.items() if k != "ground"}
    states = init_fused_state(cfg, len(x["ground"]), t["positions"])
    per = (states, t["scans"], t["masks"], t["positions"], t["quats"],
           t["goals"], t["v"], t["w"])
    if mesh is None:
        _, vx, wz, codes, ok = fleet.fused_fleet_tick(
            cfg, spec, ri, params, fmap, *per[:5], t["offset"], *per[5:])
        return [_np(v) for v in (vx, wz, codes, ok)]
    per = fleet.shard_fleet_arrays(mesh, per)
    tick = fleet.sharded_fused_fleet_tick(cfg, spec, ri, params, mesh)
    _, vx, wz, codes, ok, found = tick(fmap, *per[:5], t["offset"], *per[5:])
    return [_np(v) for v in (vx, wz, codes, ok, found)]


def port_full(normals, draws, mesh=None):
    """Per tick, the diag of :data:`FULL_DIAG` (and the found count) of
    the full tick chained ``FULL_TICKS`` times; ``normals`` the MCL's
    initial (B, N, 3) unit normals, ``draws`` per tick a dict of the
    whole fleet's unit draws by ``interop.DRAW_KEYS``."""
    from dddmr_navigation_tpu_torch import config as C
    from dddmr_navigation_tpu_torch.control.fused import (
        build_fused_map, make_fused_tick)
    from dddmr_navigation_tpu_torch.interop import port_draws
    from dddmr_navigation_tpu_torch.io import maps as M
    from dddmr_navigation_tpu_torch.parallel import fleet
    from dddmr_navigation_tpu_torch.state_estimation.likelihood import (
        build_submap_context)
    (cfg, mb, mcl), x = full_setup(C, M)
    fmap = build_fused_map(cfg, x["ground"], x["walls"], device="cpu")
    submap = build_submap_context(x["walls"], x["ground"], mcl, device="cpu")
    _, spec, ri, params = make_fused_tick(cfg)
    state = fleet.init_fleet_full_state(
        cfg, len(x["ground"]), x["positions"], x["quats"], mcl_cfg=mcl,
        mcl_normals=[torch.as_tensor(n) for n in normals], device="cpu")
    t = {k: torch.as_tensor(v) for k, v in x.items()}
    per = (state, t["scans"], t["masks"], t["goals"], t["drift"],
           t["drift_yaw"])
    if mesh is not None:
        per = fleet.shard_fleet_arrays(mesh, per)
        tick = fleet.sharded_fleet_full_tick(cfg, mb, spec, ri, params, mesh,
                                             mcl_cfg=mcl, localize=True)
    state, scans, masks, goals, drift, dyaw = per
    out = []
    for k in range(FULL_TICKS):
        d = port_draws(draws[k], "cpu")
        now, dt = torch.tensor(np.float32(0.1 * k)), torch.tensor(
            np.float32(0.1))
        if mesh is None:
            state, diag = fleet.fleet_full_tick(
                cfg, mb, spec, ri, params, fmap, state, scans, masks,
                t["offset"], goals, now, dt, mcl_cfg=mcl, submap_ctx=submap,
                odom_drift_pos=drift, odom_drift_yaw=dyaw,
                feature_map_pts=t["walls"], feature_ground_pts=t["ground"],
                mcl_draws=d)
            found = None
        else:
            d = fleet.shard_fleet_arrays(mesh, d)
            state, diag, found = tick(fmap, submap, t["walls"], t["ground"],
                                      state, scans, masks, t["offset"], goals,
                                      now, dt, drift, dyaw, mcl_draws=d)
        rec = {k_: _np(diag[k_]) for k_ in FULL_DIAG}
        rec["mcl_pos"] = _np(state.mcl.particles.pos)
        if found is not None:
            rec["found"] = _np(found)
        out.append(rec)
    return out


def _rank_worker(rank, world, port, out_dir, jobs, normals, draws):
    """One rank: join the gloo group, run ``jobs`` over this rank's block
    and save the outputs to ``out_dir/rank<rank>.npz``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    from dddmr_navigation_tpu_torch.parallel import fleet
    from dddmr_navigation_tpu_torch.parallel import multihost as mh
    assert mh.initialize_distributed(f"127.0.0.1:{port}", world, rank,
                                     device="cpu", timeout_s=PG_TIMEOUT_S)
    out = {}
    try:
        mesh = fleet.make_fleet_mesh(device="cpu")
        out["block"] = np.asarray(fleet.rank_block(mesh))
        if "local" in jobs:
            for i, v in enumerate(port_local(mesh)):
                out[f"local{i}"] = v
        if "fused" in jobs:
            for i, v in enumerate(port_fused(mesh)):
                out[f"fused{i}"] = v
        if "full" in jobs:
            for k, rec in enumerate(port_full(normals, draws, mesh)):
                for name, v in rec.items():
                    out[f"full{k}_{name}"] = v
        if "multihost" in jobs:
            hmesh = mh.make_host_mesh(2, world // 2, device="cpu")
            out["host_mesh"] = np.asarray(hmesh.mesh.shape)
            out["host_block"] = np.asarray(mh.scenario_sharding(hmesh))
            for i, v in enumerate(port_local(hmesh, multihost=True)):
                out[f"mh{i}"] = v
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(world, tmp_path, jobs, normals=None, draws=None):
    """Spawn ``world`` ranks of :func:`_rank_worker`, join each within
    JOIN_S (killing every rank on a timeout), and return their outputs."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_rank_worker,
                         args=(r, world, port, str(tmp_path), jobs, normals,
                               draws)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_S)
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not alive, f"ranks {alive} still running after {JOIN_S} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"rank exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


def _slices(world, b):
    n = b // world
    return [slice(r * n, (r + 1) * n) for r in range(world)]


# ---------------------------------------------------------------------------
# the JAX package's sharded ticks over its 8-device CPU mesh, as recorded
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_full():
    """The recorded chain of JAX's sharded full tick: the initial normals,
    each tick's draws, diag and found count."""
    from dddmr_navigation_tpu_torch.interop import DRAW_KEYS
    g = np.load(GOLDEN)
    recs, draws = [], []
    for k in range(FULL_TICKS):
        draws.append({n: g[f"full{k}_draw_{n}"] for n in DRAW_KEYS})
        recs.append({n: g[f"full{k}_{n}"] for n in FULL_DIAG + ("found",)})
    return dict(normals=(g["init_pos_n"], g["init_rpy_n"]), draws=draws,
                recs=recs)


@pytest.fixture(scope="module")
def port_unsharded(jax_full):
    return port_full(jax_full["normals"], jax_full["draws"])


def _check_full(outs, world, jax_full, unsharded):
    """Each rank's chain against its slice of the unsharded port chain
    (bit for bit, but for the relaxation count: the rank's is the largest
    of its own robots', the unsharded tick's the fleet's) and of JAX's."""
    sl = _slices(world, FULL_B)
    per_dev = FULL_B // 8
    for k in range(FULL_TICKS):
        want_j, want_u = jax_full["recs"][k], unsharded[k]
        found = [int(o[f"full{k}_found"]) for o in outs]
        assert found == [int(want_j["found"])] * world
        assert found[0] == int((want_u["ps_simple"] == 4).sum())
        for r, o in enumerate(outs):
            for name in FULL_DIAG:
                got = o[f"full{k}_{name}"]
                if name == "wf_iters":
                    dev = want_j[name][sl[r]].reshape(-1, per_dev)[:, 0]
                    assert (got == dev.max()).all(), (k, r, got, dev)
                    assert int(want_u[name][0]) >= int(got[0])
                    continue
                np.testing.assert_array_equal(got, want_u[name][sl[r]],
                                              err_msg=f"tick {k} {name}")
                if name in FULL_INT:
                    np.testing.assert_array_equal(got, want_j[name][sl[r]],
                                                  err_msg=f"JAX {name}")
                else:
                    np.testing.assert_allclose(got, want_j[name][sl[r]],
                                               rtol=2e-6, atol=1e-6,
                                               err_msg=f"JAX {name}")
            np.testing.assert_array_equal(o[f"full{k}_mcl_pos"],
                                          want_u["mcl_pos"][sl[r]])
    assert int(jax_full["recs"][-1]["plan_ok"].sum()) == FULL_B


def test_two_ranks_match_unsharded_and_jax(tmp_path, jax_full,
                                           port_unsharded):
    """A gloo group of 2: the full tick (2 chained ticks), the fused tick
    and the local tick, each rank's half against the unsharded port and
    JAX's 8-device run; the reduced counts and the mean cost equal on
    every rank."""
    outs = run_ranks(2, tmp_path, ("local", "fused", "full"),
                     jax_full["normals"], jax_full["draws"])
    assert [tuple(o["block"]) for o in outs] == [(0, 2), (1, 2)]
    _check_full(outs, 2, jax_full, port_unsharded)

    # the fused tick: 8 robots, each marks its own post
    g = np.load(GOLDEN)
    want = [g[f"fused_{n}"] for n in ("vx", "wz", "codes", "ok")]
    jfound = g["fused_found"]
    unsharded = port_fused()
    for r, (o, s) in enumerate(zip(outs, _slices(2, FUSED_B))):
        for i in range(4):
            np.testing.assert_array_equal(o[f"fused{i}"], unsharded[i][s])
        np.testing.assert_array_equal(o["fused2"], want[2][s])
        np.testing.assert_array_equal(o["fused3"], want[3][s])
        np.testing.assert_allclose(o["fused0"], want[0][s], rtol=2e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(o["fused1"], want[1][s], rtol=2e-6,
                                   atol=1e-6)
        assert float(o["fused4"]) == float(jfound) == FUSED_B

    # the local tick
    jl = [g[f"local_{n}"] for n in ("vx", "wz", "codes", "costs", "mean")]
    ul = port_local()
    for o, s in zip(outs, _slices(2, LOCAL_B)):
        for i in range(4):
            np.testing.assert_array_equal(o[f"local{i}"], ul[i][s])
        np.testing.assert_array_equal(o["local2"], jl[2][s])
        np.testing.assert_allclose(o["local3"], jl[3][s], rtol=2e-6)
        np.testing.assert_allclose(float(o["local4"]), float(jl[4]),
                                   rtol=2e-6)
        ok = ul[3] >= 0
        np.testing.assert_allclose(float(o["local4"]), ul[3][ok].mean(),
                                   rtol=2e-6)


def test_four_ranks_and_host_mesh(tmp_path, jax_full, port_unsharded):
    """A gloo group of 4: the full tick over 4 blocks of 4 robots, and the
    (dcn 2, ici 2) host mesh's hierarchical reduce of the local tick,
    against the unsharded port and JAX's 8-device mesh."""
    outs = run_ranks(4, tmp_path, ("full", "multihost"),
                     jax_full["normals"], jax_full["draws"])
    _check_full(outs, 4, jax_full, port_unsharded)
    g = np.load(GOLDEN)
    jl = [g[f"local_{n}"] for n in ("vx", "wz", "codes", "costs", "mean")]
    ul = port_local()
    for r, (o, s) in enumerate(zip(outs, _slices(4, LOCAL_B))):
        assert tuple(o["host_mesh"]) == (2, 2)
        assert tuple(o["host_block"]) == (r, 4)
        for i in range(4):
            np.testing.assert_array_equal(o[f"mh{i}"], ul[i][s])
        np.testing.assert_array_equal(o["mh2"], jl[2][s])
        np.testing.assert_allclose(float(o["mh4"]), float(jl[4]), rtol=2e-6)


def test_golden_is_jax_today():
    """The recorded local tick is what JAX's sharded tick gives now (a
    check that the golden file, ``tools/make_sharding_golden.py``, is
    current)."""
    g = np.load(GOLDEN)
    live = jax_local()
    for name, v in zip(("vx", "wz", "codes", "costs", "mean"), live):
        np.testing.assert_array_equal(g[f"local_{name}"], v, err_msg=name)
    assert int(g["full1_plan_ok"].sum()) == FULL_B


def test_initialize_distributed_noop_single_process(monkeypatch):
    """One process: a no-op that returns False and joins no group."""
    import torch.distributed as dist
    from dddmr_navigation_tpu_torch.parallel.multihost import (
        initialize_distributed)
    monkeypatch.delenv("DDDMR_COORDINATOR", raising=False)
    assert initialize_distributed() is False
    assert initialize_distributed(coordinator_address="127.0.0.1:1234",
                                  num_processes=1) is False
    monkeypatch.setenv("DDDMR_COORDINATOR", "127.0.0.1:1234")
    monkeypatch.setenv("DDDMR_NUM_PROCESSES", "1")
    assert initialize_distributed() is False
    assert not dist.is_initialized()


def test_mesh_needs_a_group_of_its_backend():
    """Without a process group there is no mesh, and a mesh on one device
    never takes another device's backend."""
    import torch.distributed as dist
    from dddmr_navigation_tpu_torch.parallel import fleet
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
        fleet.make_fleet_mesh(device="cpu")
    with pytest.raises(RuntimeError):
        fleet.make_fleet_mesh()


@pytest.mark.cuda
def test_nccl_world_of_one_matches_unsharded():
    """On the card: NCCL at world size 1; the sharded local tick equals
    the unsharded one and the reduced mean cost is its mean."""
    import torch.distributed as dist
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from dddmr_navigation_tpu_torch import config as C
    from dddmr_navigation_tpu_torch.parallel import fleet
    from dddmr_navigation_tpu_torch.planning.local.planner import (
        make_global_plan)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        cfg, x = local_setup(C)
        b = x["plan"].shape[0]
        plans = make_global_plan(x["plan"], max_len=cfg.max_plan_len)
        state = fleet.FleetState(
            pos=torch.zeros((b, 3), device="cuda"),
            quat=torch.tensor([[0.0, 0.0, 0.0, 1.0]],
                              device="cuda").repeat(b, 1),
            v=torch.zeros((b,), device="cuda"),
            w=torch.zeros((b,), device="cuda"))
        args = (plans, state, torch.as_tensor(x["obstacles"], device="cuda"),
                torch.as_tensor(x["obs_valid"], device="cuda"))
        mesh = fleet.make_fleet_mesh()
        got = fleet.sharded_fleet_tick(cfg, mesh)(*args)
        want = fleet.fleet_tick(cfg, *args)
        assert torch.equal(got[2], want.state)
        assert torch.equal(got[3], want.best_cost)
        ok = want.best_cost >= 0
        torch.testing.assert_close(
            got[4], want.best_cost[ok].sum() / ok.sum().float(), rtol=2e-6,
            atol=0.0)
    finally:
        dist.destroy_process_group()
