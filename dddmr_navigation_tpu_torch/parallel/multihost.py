"""Multi-host scaling over ``torch.distributed``: the counterpart of
``dddmr_navigation_tpu/parallel/multihost.py`` (BASELINE.json config 5:
scenarios across N ≥ 2 hosts).

One process per card. :func:`initialize_distributed` joins the process
group from the ``DDDMR_*`` environment (a no-op in one process);
:func:`make_host_mesh` lays the ranks out as a 2-D ``DeviceMesh``
(``dcn``: hosts, ``ici``: cards within a host); robots are split over both
axes flattened; the fleet-health reduce is hierarchical, one all_reduce
over the ``ici`` group (NVLink within a host) and then one over the
``dcn`` group (across hosts).
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from dddmr_navigation_tpu_torch.parallel.fleet import (
    _BACKEND, fleet_tick, rank_block)

DCN_AXIS = "dcn"   # across hosts
ICI_AXIS = "ici"   # across cards within a host


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, device="cuda",
                           timeout_s: float = 300.0) -> bool:
    """Join the default process group: a no-op that returns False in a
    single-process run, else ``init_process_group`` over
    ``tcp://<coordinator_address>`` (``host:port``) with the backend of
    ``device`` (NCCL for the card, gloo for the CPU) and a timeout, and
    True. Each argument falls back to the environment: DDDMR_COORDINATOR,
    DDDMR_NUM_PROCESSES, DDDMR_PROCESS_ID."""
    coordinator_address = coordinator_address or os.environ.get(
        "DDDMR_COORDINATOR")
    num_processes = num_processes if num_processes is not None else int(
        os.environ.get("DDDMR_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("DDDMR_PROCESS_ID", "0"))
    if coordinator_address is None or num_processes <= 1:
        return False
    dist.init_process_group(
        backend=_BACKEND[torch.device(device).type],
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def make_host_mesh(n_hosts: int | None = None,
                   devices_per_host: int | None = None, device="cuda"):
    """The (dcn, ici) ``DeviceMesh`` over every rank, ranks of one host
    contiguous. ``devices_per_host`` defaults to the cards this process
    sees (the CPU: every rank on one host), ``n_hosts`` to the world size
    over it; their product must be the world size."""
    from torch.distributed.device_mesh import init_device_mesh
    device_type = torch.device(device).type
    world = dist.get_world_size()
    if devices_per_host is None:
        devices_per_host = (torch.cuda.device_count() if device_type == "cuda"
                            else world // (n_hosts or 1))
    if n_hosts is None:
        n_hosts = world // devices_per_host
    if n_hosts * devices_per_host != world:
        raise ValueError(f"a {n_hosts} x {devices_per_host} mesh does not "
                         f"cover {world} ranks")
    return init_device_mesh(device_type, (n_hosts, devices_per_host),
                            mesh_dim_names=(DCN_AXIS, ICI_AXIS))


def scenario_sharding(mesh) -> tuple[int, int]:
    """This rank's block of the scenario batch, split over hosts × cards
    flattened: (block index, number of blocks)."""
    return rank_block(mesh)


def sharded_fleet_tick_multihost(cfg, mesh):
    """The fleet control tick over this rank's robots on the (dcn, ici)
    mesh; the fleet-health scalar (mean best cost of the robots that found
    a trajectory) is a hierarchical reduce of [sum, count]: one
    all_reduce over ``ici``, then one over ``dcn``. The returned callable
    takes this rank's (plans, state, obstacles, obs_valid) and returns
    (vx, wz, state codes, best costs, mean cost)."""
    ici, dcn = mesh.get_group(ICI_AXIS), mesh.get_group(DCN_AXIS)

    def tick(plans, state, obstacles, obs_valid):
        cmd = fleet_tick(cfg, plans, state, obstacles, obs_valid)
        ok = cmd.best_cost >= 0
        local = torch.stack([torch.where(ok, cmd.best_cost, 0.0).sum(),
                             ok.to(torch.float32).sum()])
        dist.all_reduce(local, group=ici)      # within a host, wide + fast
        dist.all_reduce(local, group=dcn)      # the small cross-host rest
        return (cmd.vx, cmd.wz, cmd.state, cmd.best_cost,
                local[0] / torch.clamp(local[1], min=1.0))
    return tick


def host_local_batch(mesh, tree):
    """Each rank's own robots as the sharded batch: ``tree`` holds this
    rank's block of ``mesh`` (see :func:`scenario_sharding`) and is
    returned as it is, with no gather across ranks."""
    return tree
