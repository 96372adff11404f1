"""Dynamic obstacle marking / clearing and the ground-node distance field,
batched over robots.

Counterpart of ``dddmr_navigation_tpu/perception/marking.py`` (the
reference's `cluster_marking.cpp`, `multilayer_spinning_lidar.cpp`,
`dynamic_graph.cpp`): a dense scrolled window grid per robot, clusters by
min-label propagation, range-image clearing of the extracted marked cells,
and a per-tick recompute of the in-window ground-node distances.

The JAX version's drop-mode scatters write into one extra sink slot that is
sliced off; every scatter here writes one value per target (or the same
value to repeated targets), so its result does not depend on the order the
writes land in.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dddmr_navigation_tpu_torch.geometry import quat_rotate_fma
from dddmr_navigation_tpu_torch.rounding import fma_dot, sqrt_rn
from dddmr_navigation_tpu_torch.ops.compaction import first_k_true_indices
from dddmr_navigation_tpu_torch.ops.cuda_graph import GraphedStep
from dddmr_navigation_tpu_torch.perception.voxel import (
    VoxelSpec, device_constant, world_to_cell, cell_to_world,
    window_origin_for, in_window, scroll_grid)
from dddmr_navigation_tpu_torch.perception.fov import (
    _RAD2DEG, RangeImageSpec, bins, build_range_image, in_fov,
    sensor_frame_spherical, spherical_rad)
from dddmr_navigation_tpu_torch.perception.clustering import (
    label_components, label_components_pooled, cluster_table)
from dddmr_navigation_tpu_torch.perception.static_map import (
    MapContext, distance_to_ground, near_static)
from dddmr_navigation_tpu_torch.runtime import tracing


class MarkingParams(NamedTuple):
    """Static marking parameters; names mirror the reference's lidar-layer
    YAML keys (the JAX package's ``MarkingParams``)."""
    vertical_FOV_top: float = 15.0
    vertical_FOV_bottom: float = -15.0
    scan_effective_positive_start: float = 30.0
    scan_effective_positive_end: float = 180.0
    scan_effective_negative_start: float = -30.0
    scan_effective_negative_end: float = -180.0
    marking_height: float = 2.0
    segmentation_ignore_ratio: float = 1.1
    cluster_tol_cells: int = 2
    cluster_iters: int = 24
    cluster_pool: int = 1
    max_clusters: int = 64
    max_marked_voxels: int = 2048
    max_window_nodes: int = 8192
    inflation_radius: float = 1.5
    inscribed_radius: float = 0.5
    max_obstacle_distance: float = 9999.0
    clear_range_margin: float = 0.05
    reobserve_margin: float = 0.10

    @classmethod
    def from_config(cls, pcfg) -> "MarkingParams":
        """From a ``PerceptionConfig``, as the JAX package builds it."""
        lidar = pcfg.lidar
        return cls(
            vertical_FOV_top=lidar.vertical_FOV_top,
            vertical_FOV_bottom=lidar.vertical_FOV_bottom,
            scan_effective_positive_start=lidar.scan_effective_positive_start,
            scan_effective_positive_end=lidar.scan_effective_positive_end,
            scan_effective_negative_start=lidar.scan_effective_negative_start,
            scan_effective_negative_end=lidar.scan_effective_negative_end,
            marking_height=lidar.marking_height,
            segmentation_ignore_ratio=lidar.segmentation_ignore_ratio,
            max_marked_voxels=pcfg.max_marked_voxels,
            max_window_nodes=getattr(pcfg, "max_window_nodes", 8192),
            cluster_pool=getattr(pcfg, "cluster_pool", 1),
            inflation_radius=pcfg.inflation_radius,
            inscribed_radius=pcfg.inscribed_radius,
            max_obstacle_distance=pcfg.max_obstacle_distance,
        )

    def fov(self, elev, azim):
        return in_fov(
            elev, azim,
            vertical_FOV_bottom=self.vertical_FOV_bottom,
            vertical_FOV_top=self.vertical_FOV_top,
            scan_effective_positive_start=self.scan_effective_positive_start,
            scan_effective_positive_end=self.scan_effective_positive_end,
            scan_effective_negative_start=self.scan_effective_negative_start,
            scan_effective_negative_end=self.scan_effective_negative_end)


class MarkingState(NamedTuple):
    """Per-robot dynamic perception state, batched on axis 0."""
    grid: torch.Tensor          # (B, Nx, Ny, Nz) uint8 marked cells
    origin: torch.Tensor        # (B, 3) int32 window origin (global voxels)
    dgraph: torch.Tensor        # (B, G) f32 distance-to-obstacle per node
    clear_offset: torch.Tensor  # (B,) int32 start of the clear-test window


def init_marking_state(spec: VoxelSpec, params: MarkingParams,
                       num_ground_nodes: int, robot_xyz) -> MarkingState:
    """Empty grids centered on ``robot_xyz`` (B, 3)."""
    b = robot_xyz.shape[0]
    dev = robot_xyz.device
    return MarkingState(
        grid=torch.zeros((b, spec.nx, spec.ny, spec.nz), dtype=torch.uint8,
                         device=dev),
        origin=window_origin_for(spec, robot_xyz),
        dgraph=torch.full((b, num_ground_nodes), params.max_obstacle_distance,
                          dtype=torch.float32, device=dev),
        clear_offset=torch.zeros((b,), dtype=torch.int32, device=dev))


def _cells_of(spec: VoxelSpec, flat_idx, origin):
    """Global voxel coords (B, k, 3) of window-linear indices (B, k) ≥ 0."""
    iz = flat_idx % spec.nz
    iy = (flat_idx // spec.nz) % spec.ny
    ix = flat_idx // (spec.ny * spec.nz)
    return torch.stack([ix, iy, iz], dim=-1).int() + origin[:, None, :]


def _window_cell_positions(spec: VoxelSpec, origin):
    """(B, Nx, Ny, Nz, 3) world position of every window cell (its corner)."""
    n = spec.nx * spec.ny * spec.nz
    lin = torch.arange(n, device=origin.device).expand(origin.shape[0], n)
    return cell_to_world(spec, _cells_of(spec, lin, origin)).view(
        -1, spec.nx, spec.ny, spec.nz, 3)


def clear_marked(spec: VoxelSpec, ri_spec: RangeImageSpec,
                 params: MarkingParams, grid, origin,
                 sensor_pos, sensor_quat, scan_pts, scan_mask, clear_offset):
    """Range-image clearing of each robot's marked grid (selfClear): a marked
    cell stays when it is outside the FOV, blocked by a closer return, or
    re-observed; otherwise it is cleared. Only the first
    ``max_marked_voxels`` marked cells from ``clear_offset`` on (wrapping)
    are tested this tick."""
    b = grid.shape[0]
    n_valid = scan_mask.sum(dim=1)
    img = build_range_image(ri_spec, sensor_pos, sensor_quat, scan_pts,
                            scan_mask)
    # 3×3 min-pool (rows clamp, cols wrap): lookup_range's neighborhood min.
    rows = torch.arange(ri_spec.rows, device=img.device)
    pooled = img
    for dr in (-1, 0, 1):
        shifted = img[:, torch.clamp(rows + dr, 0, ri_spec.rows - 1)]
        for dc in (-1, 0, 1):
            pooled = torch.minimum(pooled, torch.roll(shifted, dc, dims=2))

    flat = grid.reshape(b, -1).bool()
    n_cells = flat.shape[1]
    off = clear_offset.long() % n_cells                          # (B,)
    lin = torch.arange(n_cells, device=grid.device)
    rolled = flat.gather(1, (lin + off[:, None]) % n_cells)   # roll by -off
    idx_rot = first_k_true_indices(rolled, params.max_marked_voxels)
    valid = idx_rot >= 0
    idx = torch.where(valid, (idx_rot + off[:, None]) % n_cells, -1)
    pos = cell_to_world(spec, _cells_of(spec, torch.clamp(idx, min=0), origin))

    rng, elev, azim = spherical_rad(sensor_pos, sensor_quat, pos)
    fov = params.fov(elev * _RAD2DEG, azim * _RAD2DEG)
    row, col = bins(ri_spec, elev, azim)
    scan_r = pooled.view(b, -1).gather(1, row.long() * ri_spec.cols + col.long())
    blocked = scan_r < rng - params.clear_range_margin
    reobserved = torch.abs(scan_r - rng) <= params.reobserve_margin
    keep = (~fov) | blocked | reobserved
    # With a (near) empty scan free space cannot be asserted: keep all.
    clear = valid & ~keep & (n_valid >= 5)[:, None]
    flat = torch.cat([flat, flat.new_zeros((b, 1))], dim=1)
    flat.scatter_(1, torch.where(clear, idx, n_cells), False)
    return flat[:, :n_cells].view(grid.shape).to(torch.uint8)


def mark_scan(spec: VoxelSpec, params: MarkingParams, grid, origin,
              map_ctx: MapContext, scan_pts, scan_mask, robot_pos, robot_quat,
              sensor_pos, sensor_quat):
    """Cluster each robot's scan and mark the accepted clusters (selfMark)."""
    b = grid.shape[0]
    n_cells = spec.nx * spec.ny * spec.nz
    rel_z = scan_pts[..., 2] - robot_pos[:, None, 2]
    local = world_to_cell(spec, scan_pts) - origin[:, None, :]
    ok = (scan_mask & in_window(spec, local)
          & (rel_z >= 0.0) & (rel_z <= params.marking_height))
    hi = device_constant((spec.nx - 1, spec.ny - 1, spec.nz - 1),
                         torch.int64, local.device)
    local = torch.minimum(torch.clamp(local, min=0), hi).long()
    lin = (local[..., 0] * spec.ny + local[..., 1]) * spec.nz + local[..., 2]
    # The JAX version's bool .at[].max: every occupied target gets True.
    occ = torch.zeros((b, n_cells + 1), dtype=torch.bool, device=grid.device)
    occ.scatter_(1, torch.where(ok, lin, n_cells), True)
    scan_occ = occ[:, :n_cells].view(b, spec.nx, spec.ny, spec.nz)

    if params.cluster_pool > 1:
        labels, root_mask = label_components_pooled(
            scan_occ, params.cluster_pool, params.cluster_iters)
    else:
        labels = label_components(scan_occ, params.cluster_tol_cells,
                                  params.cluster_iters)
        root_mask = None
    pos = _window_cell_positions(spec, origin)
    centroids, sizes, cell_idx = cluster_table(
        labels, scan_occ, pos, params.max_clusters, root_mask=root_mask)

    # Cluster accept tests (reference multilayer_spinning_lidar.cpp:369-432).
    ground_attached = distance_to_ground(map_ctx, centroids) <= 0.05
    if params.segmentation_ignore_ratio <= 0.999:
        static_hit = near_static(map_ctx, centroids, 0.1)
    else:
        static_hit = torch.zeros_like(ground_attached)
    _, elev_c, azim_c = sensor_frame_spherical(sensor_pos, sensor_quat,
                                               centroids)
    accept = ((sizes > 0) & ~ground_attached & ~static_hit
              & params.fov(elev_c, azim_c))                       # (B, K)
    # Per-cell accept: one gather from the (K + 1,) table, the last entry
    # False for unclustered cells (the JAX version's one-hot any-reduce).
    table = torch.cat([accept, accept.new_zeros((b, 1))], dim=1)
    k = params.max_clusters
    cell_accept = table.gather(
        1, torch.where(cell_idx >= 0, cell_idx, k).view(b, -1)).view(grid.shape)
    return torch.maximum(grid, cell_accept.to(torch.uint8))


def _sq_dists(a, b):
    """|a-b|² as |a|² + |b|² − 2a·b, clamped at 0; (B, n, d) × (B, k, d) →
    (B, n, k). The JAX version takes the cross term as a matmul at
    Precision.HIGHEST, which XLA on the CPU computes as a chain of fused
    multiply-adds; cuBLAS would round it otherwise, and a one-ulp change
    of a node's distance re-opens the warm relaxation for iterations. So
    every term is :func:`fma_dot`, and the inflation gate and the distance
    field come out as the JAX version's, on the card too."""
    a2 = fma_dot(a, a)
    b2 = fma_dot(b, b)
    cross = fma_dot(a[:, :, None, :], b[:, None, :, :])
    return torch.clamp(a2[:, :, None] + b2[:, None, :] - 2.0 * cross, min=0.0)


def update_dgraph(spec: VoxelSpec, params: MarkingParams, grid, origin,
                  dgraph, map_ctx: MapContext, robot_pos, robot_quat):
    """Recompute each robot's in-window ground-node distances from its marked
    set: marked cells projected onto the robot's base plane, gated by the
    3D ``inflation_radius``, valued by the XY distance
    (`cluster_marking.cpp:54-96`). While the recorder is on, the device
    counters ``marked_cells`` and ``marked_kept`` add the marked cells seen
    and those the cap keeps."""
    dgraph, seen, kept = _update_dgraph(spec, params, grid, origin, dgraph,
                                        map_ctx, robot_pos, robot_quat)
    if tracing.on():
        tracing.count_device("marked_cells", seen)
        tracing.count_device("marked_kept", kept)
    return dgraph


def _update_dgraph(spec: VoxelSpec, params: MarkingParams, grid, origin,
                   dgraph, map_ctx: MapContext, robot_pos, robot_quat):
    """:func:`update_dgraph`'s distances, and the marked cells seen and
    kept as device scalars."""
    b = grid.shape[0]
    g = dgraph.shape[1]
    flat = grid.reshape(b, -1).bool()
    mark_idx = first_k_true_indices(flat, params.max_marked_voxels)
    mark_valid = mark_idx >= 0
    mpts = cell_to_world(spec, _cells_of(spec, torch.clamp(mark_idx, min=0),
                                         origin))                  # (B, k, 3)

    z = device_constant((0.0, 0.0, 1.0), torch.float32, grid.device)
    normal = quat_rotate_fma(robot_quat, z.expand_as(robot_pos))[:, None, :]
    offs = fma_dot(mpts - robot_pos[:, None, :], normal)
    mproj = mpts - offs[..., None] * normal

    half_extent = 0.5 * spec.nx * spec.xy_resolution + params.inflation_radius
    ground = map_ctx.ground
    near = (map_ctx.ground_valid
            & (torch.abs(ground[:, 0] - robot_pos[:, 0, None]) <= half_extent)
            & (torch.abs(ground[:, 1] - robot_pos[:, 1, None]) <= half_extent))
    # Rows past the G-th are padding in the JAX version and dropped there.
    node_idx = first_k_true_indices(near, min(params.max_window_nodes, g))
    node_valid = node_idx >= 0
    nodes = ground[torch.clamp(node_idx, 0, g - 1)]                # (B, n, 3)

    # Recentered on the robot: at O(100 m) coordinates the expansion's
    # cancellation would cost centimeters.
    nodes_c = nodes - robot_pos[:, None, :]
    mproj_c = mproj - robot_pos[:, None, :]
    d3sq = _sq_dists(nodes_c, mproj_c)
    dxy = sqrt_rn(_sq_dists(nodes_c[..., :2].contiguous(),
                               mproj_c[..., :2].contiguous()))
    use = mark_valid[:, None, :] & (d3sq <= params.inflation_radius ** 2)
    dxy = torch.where(use, dxy, params.max_obstacle_distance)
    node_d = dxy.amin(dim=2)

    out = torch.cat([dgraph, dgraph.new_zeros((b, 1))], dim=1)
    out.scatter_(1, torch.where(node_valid, node_idx, g),
                 torch.where(node_valid, node_d, 0.0))
    return out[:, :g], flat.sum(), mark_valid.sum()


# The mark/clear step's CUDA graphs (one per shape, spec, params and map).
MARK_CLEAR_GRAPHS = GraphedStep("mark_clear")


def perception_update(spec: VoxelSpec, ri_spec: RangeImageSpec,
                      params: MarkingParams, state: MarkingState,
                      map_ctx: MapContext, scan_pts, scan_mask,
                      robot_pos, robot_quat, sensor_pos, sensor_quat
                      ) -> MarkingState:
    """One mark/clear tick: scroll the window, clear, mark, recompute the
    distance field (`StackedPerception::doClear_then_Mark`,
    `stacked_perception.cpp:72-90`). On CUDA tensors the step replays as
    a CUDA graph (:data:`MARK_CLEAR_GRAPHS`, keyed by the shapes, the
    static arguments and the map); on CPU tensors it runs
    eagerly. While the recorder is on, the device counters
    ``marked_cells`` and ``marked_kept`` add the marked cells seen and
    those the cap keeps."""
    tensors = (state.grid, state.origin, state.dgraph, state.clear_offset,
               scan_pts, scan_mask, robot_pos, robot_quat, sensor_pos,
               sensor_quat)

    def step(*t):
        return _perception_step(spec, ri_spec, params, map_ctx, *t)
    if scan_pts.is_cuda:
        out = MARK_CLEAR_GRAPHS(step, (spec, ri_spec, params, id(map_ctx)),
                                tensors, keep=map_ctx)
    else:
        out = step(*tensors)
    if tracing.on():
        tracing.count_device("marked_cells", out[4])
        tracing.count_device("marked_kept", out[5])
    return MarkingState(*out[:4])


def _perception_step(spec: VoxelSpec, ri_spec: RangeImageSpec,
                     params: MarkingParams, map_ctx: MapContext, grid,
                     origin, dgraph, clear_offset, scan_pts, scan_mask,
                     robot_pos, robot_quat, sensor_pos, sensor_quat) -> tuple:
    """:func:`perception_update`'s eager body: (grid, origin, dgraph,
    clear_offset, marked cells seen, marked cells kept). It makes no host
    read and no host-to-device copy, so a CUDA graph can capture it."""
    new_origin = window_origin_for(spec, robot_pos)
    grid = scroll_grid(grid, origin, new_origin)
    grid = clear_marked(spec, ri_spec, params, grid, new_origin,
                        sensor_pos, sensor_quat, scan_pts, scan_mask,
                        clear_offset)
    grid = mark_scan(spec, params, grid, new_origin, map_ctx, scan_pts,
                     scan_mask, robot_pos, robot_quat, sensor_pos, sensor_quat)
    dgraph, seen, kept = _update_dgraph(spec, params, grid, new_origin,
                                        dgraph, map_ctx, robot_pos,
                                        robot_quat)
    n_cells = spec.nx * spec.ny * spec.nz
    return (grid, new_origin, dgraph,
            ((clear_offset + params.max_marked_voxels) % n_cells).int(),
            seen, kept)
