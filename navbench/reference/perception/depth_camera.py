"""Depth-camera marking/clearing layer, batched over robots.

Counterpart of ``dddmr_navigation_tpu/perception/depth_camera.py``
(``perception_3d::DepthCameraLayer`` + ``FrustumUtils``,
`depth_camera_layer.cpp:197-620`, `frustum_utils.cpp:219-291`): each robot
keeps an N-deep ring of observations per camera; a marked voxel inside any
live observation's frustum is cleared unless that observation's depth
cloud blocks the line of sight (an angular range image) or attaches to it
(a depth point within 0.2 m); the latest live frame of each camera marks.

Only marked voxels can be cleared, so the frustum, range-image and attach
tests run on the marked voxels alone (one ``nonzero`` a call, a host sync),
with the JAX version's elementwise formulas. The attach test's (voxels ×
points) squared distances are taken in chunks of ``ATTACH_CHUNK`` pairs.

Rounding: the JAX package runs these functions inside jitted programs, so
dot products and norms are FMA chains (``rounding.fma_dot``), divisions by
a constant multiply by its reciprocal, atan2 is XLA's
(``rounding.atan2_xla``), and the frustum's cos/sin constants are the
correctly rounded f32 values XLA folds them to.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from navbench.reference.geometry import (
    quat_inverse_rotate_fma, quat_rotate_fma)
from navbench.reference.rounding import (
    atan2_xla, fma_dot, fma_norm, recip_times)
from navbench.reference.perception.voxel import (
    VoxelSpec, cell_to_world, in_window, scroll_grid, window_origin_for,
    world_to_cell)

# (voxel, point) pairs of one chunk of the attach test
ATTACH_CHUNK = 1 << 22
_AZ_BINS, _EL_BINS = 32, 24


class CameraModel(NamedTuple):
    """Static pinhole description (near/far planes and full FOV angles)."""
    h_fov: float = 1.0     # full horizontal FOV (radians)
    v_fov: float = 0.8
    min_detect_distance: float = 0.3
    max_detect_distance: float = 2.5


def _f32_of(fn, x: float) -> float:
    """fn(x) correctly rounded to f32, for an f32 argument."""
    return float(np.float32(fn(float(np.float32(x)))))


@functools.lru_cache(maxsize=None)
def _frustum_frame(cam: CameraModel, device):
    """The camera-frame plane normals (6, 3) and near/far axis points
    (2, 3) on ``device``, copied there once per camera model."""
    th, tv = cam.h_fov / 2.0, cam.v_fov / 2.0
    cl, sl = _f32_of(math.cos, th), _f32_of(math.sin, th)
    cv, sv = _f32_of(math.cos, tv), _f32_of(math.sin, tv)
    normals = torch.tensor([[1.0, 0.0, 0.0], [sl, -cl, 0.0], [sl, cl, 0.0],
                            [-1.0, 0.0, 0.0], [sv, 0.0, -cv], [sv, 0.0, cv]],
                           device=device)
    axis = torch.tensor([[cam.min_detect_distance, 0.0, 0.0],
                         [cam.max_detect_distance, 0.0, 0.0]], device=device)
    return normals, axis


def frustum_planes(cam: CameraModel, cam_pos, cam_quat):
    """The 6 frustum planes of each camera pose (..., 3), (..., 4) as
    (inward normals (..., 6, 3), points (..., 6, 3)); camera frame +x
    forward, +y left, +z up."""
    normals, axis = _frustum_frame(cam, cam_pos.device)
    normals = quat_rotate_fma(cam_quat[..., None, :], normals)
    near_far = cam_pos[..., None, :] + quat_rotate_fma(
        cam_quat[..., None, :], axis)
    apex = cam_pos[..., None, :]
    pts = torch.cat([near_far[..., :1, :], apex, apex, near_far[..., 1:, :],
                     apex, apex], dim=-2)
    return normals, pts


def in_frustum(normals, plane_pts, query):
    """Inside test of (..., 3) points: all 6 signed distances ≥ 0
    (`frustum_utils.cpp:243-285`)."""
    d = query[..., None, :] - plane_pts
    return (fma_dot(d, normals) >= 0.0).all(dim=-1)


def depth_image_to_points(depth, fx, fy, cx, cy, depth_scale: float = 1.0):
    """`depthimg2pointcloud_node.cpp:27-170`: a depth image (H, W) and its
    intrinsics → (H·W, 3) optical-frame points (+z forward) and a validity
    mask."""
    h, w = depth.shape
    dev = depth.device
    u = torch.arange(w, dtype=torch.float32, device=dev).expand(h, w)
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    z = depth.float() * depth_scale
    x = (u - cx) / fx * z
    y = (v - cy) / fy * z
    return (torch.stack([x, y, z], dim=-1).reshape(-1, 3),
            (z > 0.05).reshape(-1))


def optical_to_forward(pts):
    """Optical (+z forward, +x right, +y down) → body (+x forward, +y left,
    +z up)."""
    return torch.stack([pts[..., 2], -pts[..., 0], -pts[..., 1]], dim=-1)


class DepthCameraObservation(NamedTuple):
    """Observations on leading axes (B, O): robots, then cameras or
    buffered frames."""
    cam_pos: torch.Tensor    # (B, O, 3)
    cam_quat: torch.Tensor   # (B, O, 4)
    points: torch.Tensor     # (B, O, P, 3) world-frame depth points
    mask: torch.Tensor       # (B, O, P)


class DepthCameraBuffer(NamedTuple):
    """Each robot's N-deep observation ring per camera, with expiry
    (`depth_camera_observation_buffer.cpp:78` `bufferCloud` +
    `purgeStaleObservations`). Leading axes (robots, cameras, depth)."""
    cam_pos: torch.Tensor    # (B, C, N, 3)
    cam_quat: torch.Tensor   # (B, C, N, 4)
    points: torch.Tensor     # (B, C, N, P, 3)
    mask: torch.Tensor       # (B, C, N, P)
    stamp: torch.Tensor      # (B, C, N) f32, -inf = empty slot
    head: torch.Tensor       # (B, C) int32 next write slot


def init_depth_buffer(n_cameras: int, depth: int, max_points: int,
                      robots: int = 1, device="cuda") -> DepthCameraBuffer:
    shape = (robots, n_cameras, depth)
    quat = torch.zeros(shape + (4,), device=device)
    quat[..., 3] = 1.0
    return DepthCameraBuffer(
        cam_pos=torch.zeros(shape + (3,), device=device),
        cam_quat=quat,
        points=torch.zeros(shape + (max_points, 3), device=device),
        mask=torch.zeros(shape + (max_points,), dtype=torch.bool,
                         device=device),
        stamp=torch.full(shape, -torch.inf, device=device),
        head=torch.zeros((robots, n_cameras), dtype=torch.int32,
                         device=device))


def push_observation(buf: DepthCameraBuffer, cam_idx: int, cam_pos,
                     cam_quat, points, mask, stamp) -> DepthCameraBuffer:
    """bufferCloud: write each robot's frame of camera ``cam_idx`` into its
    ring, over the oldest slot. cam_pos (B, 3), cam_quat (B, 4), points
    (B, P, 3), mask (B, P), stamp () or (B,)."""
    b, _, depth = buf.stamp.shape
    rows = torch.arange(b, device=buf.head.device)
    slot = buf.head[:, cam_idx].long()
    out = {}
    for name, value in (("cam_pos", cam_pos), ("cam_quat", cam_quat),
                        ("points", points), ("mask", mask)):
        t = getattr(buf, name).clone()
        t[rows, cam_idx, slot] = value
        out[name] = t
    stamps = buf.stamp.clone()
    stamps[rows, cam_idx, slot] = torch.as_tensor(
        stamp, dtype=torch.float32, device=stamps.device).expand(b)
    head = buf.head.clone()
    head[:, cam_idx] = ((slot + 1) % depth).int()
    return DepthCameraBuffer(stamp=stamps, head=head, **out)


def live_observations(buf: DepthCameraBuffer, now, keep_time: float):
    """(B, C, N) liveness after expiry (`purgeStaleObservations`): frames
    older than ``keep_time`` drop out. ``now`` is () or (B,)."""
    now = torch.as_tensor(now, dtype=torch.float32,
                          device=buf.stamp.device).reshape(-1, 1, 1)
    return torch.isfinite(buf.stamp) & (now - buf.stamp <= keep_time)


def buffer_as_observations(buf: DepthCameraBuffer, now, keep_time: float):
    """The (C, N) ring as one observation axis O = C·N, expired frames
    masked out. Returns (DepthCameraObservation, live (B, O))."""
    live = live_observations(buf, now, keep_time)
    b, c, n, p, _ = buf.points.shape
    live = live.reshape(b, c * n)
    return DepthCameraObservation(
        cam_pos=buf.cam_pos.reshape(b, c * n, 3),
        cam_quat=buf.cam_quat.reshape(b, c * n, 4),
        points=buf.points.reshape(b, c * n, p, 3),
        mask=buf.mask.reshape(b, c * n, p) & live[..., None]), live


def latest_live_observations(buf: DepthCameraBuffer, now, keep_time: float
                             ) -> DepthCameraObservation:
    """Each camera's most recent live frame (the first of equal stamps,
    as ``jnp.argmax``); a camera with none comes back fully masked."""
    live = live_observations(buf, now, keep_time)
    stamp = torch.where(live, buf.stamp, -torch.inf)
    newest = torch.argmax(stamp, dim=2)                       # (B, C)
    b, c = newest.shape
    rows = torch.arange(b, device=newest.device)[:, None]
    cams = torch.arange(c, device=newest.device)[None, :]
    return DepthCameraObservation(
        cam_pos=buf.cam_pos[rows, cams, newest],
        cam_quat=buf.cam_quat[rows, cams, newest],
        points=buf.points[rows, cams, newest],
        mask=buf.mask[rows, cams, newest] & live.any(dim=2)[..., None])


def depth_layer_update(spec: VoxelSpec, params, cam: CameraModel, marking,
                       buf: DepthCameraBuffer, now, keep_time: float,
                       map_ctx, robot_pos, robot_quat):
    """One DepthCameraLayer tick on each robot's own marking grid
    (`depth_camera_layer.cpp:226-620`): clear against every live buffered
    frustum, mark from the latest live frame of each camera, recompute the
    layer's distance field. Returns (MarkingState, latest observations)."""
    from navbench.reference.perception.marking import update_dgraph
    origin = window_origin_for(spec, robot_pos)
    grid = scroll_grid(marking.grid, marking.origin, origin)
    all_obs, all_live = buffer_as_observations(buf, now, keep_time)
    latest = latest_live_observations(buf, now, keep_time)
    grid = clear_with_frustums(spec, cam, grid, origin, all_obs,
                               live=all_live)
    grid = mark_depth_points(spec, grid, origin, latest, robot_pos[:, 2],
                             params.marking_height)
    dgraph = update_dgraph(spec, params, grid, origin, marking.dgraph,
                           map_ctx, robot_pos, robot_quat)
    return marking._replace(grid=grid, origin=origin, dgraph=dgraph), latest


def _angular_bins(cam: CameraModel, d):
    """Range-image bin (azimuth × elevation, 32 × 24) of camera-frame
    directions (..., 3)."""
    az = atan2_xla(d[..., 1], d[..., 0])
    el = atan2_xla(d[..., 2], fma_norm(d[..., :2]))
    bi = torch.floor((az + cam.h_fov / 2) * recip_times(cam.h_fov, _AZ_BINS))
    bj = torch.floor((el + cam.v_fov / 2) * recip_times(cam.v_fov, _EL_BINS))
    return (torch.clamp(bi, 0, _AZ_BINS - 1).long() * _EL_BINS
            + torch.clamp(bj, 0, _EL_BINS - 1).long())


def clear_with_frustums(spec: VoxelSpec, cam: CameraModel, grid, origin,
                        observations: DepthCameraObservation,
                        range_margin: float = 0.1, attach_dist: float = 0.2,
                        live=None):
    """selfClear (`depth_camera_layer.cpp:226-456`): a marked voxel inside
    any live observation's frustum is cleared unless that observation's
    depth cloud blocks the line of sight (range image) or a depth point
    lies within ``attach_dist`` of it (`FrustumUtils::isAttachFRUSTUMs`,
    `frustum_utils.cpp:219-291`). grid (B, Nx, Ny, Nz), origin (B, 3),
    observations on (B, O); ``live`` (B, O) masks expired frames."""
    b = grid.shape[0]
    flat = grid.reshape(b, -1).bool()
    rb, rv = torch.nonzero(flat, as_tuple=True)          # marked voxels
    if rb.numel() == 0:
        return grid
    nyz = spec.ny * spec.nz
    cells = torch.stack([rv // nyz, (rv // spec.nz) % spec.ny, rv % spec.nz],
                        dim=-1).int() + origin[rb]
    pos = cell_to_world(spec, cells)                     # (n, 3)

    cam_pos, cam_quat = observations.cam_pos, observations.cam_quat
    n_obs = cam_pos.shape[1]
    normals, ppts = frustum_planes(cam, cam_pos, cam_quat)
    inside = in_frustum(normals[rb], ppts[rb], pos[:, None, :])   # (n, O)

    # the range image of each observation's depth cloud
    d_pts = quat_inverse_rotate_fma(cam_quat[:, :, None, :],
                                    observations.points
                                    - cam_pos[:, :, None, :])
    r_pts = fma_norm(d_pts)
    n_bins = _AZ_BINS * _EL_BINS
    mask = observations.mask
    img = torch.full((b * n_obs, n_bins), torch.inf, device=grid.device)
    img.scatter_reduce_(
        1, torch.where(mask, _angular_bins(cam, d_pts), n_bins - 1).view(
            b * n_obs, -1),
        torch.where(mask, r_pts, torch.inf).view(b * n_obs, -1), "amin")

    d_vox = quat_inverse_rotate_fma(cam_quat[rb],
                                    pos[:, None, :] - cam_pos[rb])
    r_vox = fma_norm(d_vox)                                      # (n, O)
    row = rb[:, None] * n_obs + torch.arange(n_obs, device=rb.device)
    seen = img.view(-1)[row * n_bins + _angular_bins(cam, d_vox)]
    blocked = torch.isfinite(seen) & (seen < r_vox - range_margin)

    # attach: a depth point of the same observation within attach_dist
    points = observations.points
    n_pts = points.shape[2]
    step = max(1, ATTACH_CHUNK // max(1, n_obs * n_pts))
    attached = []
    for s in range(0, rb.numel(), step):
        rows = rb[s:s + step]
        d = pos[s:s + step, None, None, :] - points[rows]
        d2 = torch.where(mask[rows], fma_dot(d, d), torch.inf)
        attached.append(d2.amin(dim=2) <= attach_dist ** 2)
    attached = torch.cat(attached)

    if live is not None:
        inside = inside & live[rb]
    keep = (inside & (blocked | attached)).any(dim=1)
    cleared = inside.any(dim=1) & ~keep
    flat = flat.clone()
    flat[rb, rv] = ~cleared
    return flat.view(grid.shape).to(torch.uint8)


def mark_depth_points(spec: VoxelSpec, grid, origin,
                      observations: DepthCameraObservation,
                      robot_z, marking_height: float):
    """selfMark (`depth_camera_layer.cpp:458-620`): voxelize every robot's
    depth points (B, O, P, 3) within the marking band above robot_z (B,)."""
    b = grid.shape[0]
    n_cells = spec.nx * spec.ny * spec.nz
    pts = observations.points.reshape(b, -1, 3)
    ok = observations.mask.reshape(b, -1)
    rel_z = pts[..., 2] - robot_z[:, None]
    local = world_to_cell(spec, pts) - origin[:, None, :]
    ok = (ok & in_window(spec, local) & (rel_z >= 0.0)
          & (rel_z <= marking_height))
    local = local.long()
    # out-of-window points index the sink slot n_cells
    lin = (local[..., 0] * spec.ny + local[..., 1]) * spec.nz + local[..., 2]
    occ = torch.zeros((b, n_cells + 1), dtype=torch.bool, device=grid.device)
    occ.scatter_(1, torch.where(ok, lin, n_cells), True)
    return torch.maximum(grid, occ[:, :n_cells].view(grid.shape).to(
        torch.uint8))
