"""Procedural labeled RGB-D scenes for training/evaluating the
segmentation net.

The reference trains DDRNet offline on Mapillary-class data and ships a
TensorRT engine (`scripts/trt_interface.py:16-80`,
`data/colors_mapillary*.csv`); camera data cannot be shipped here, so the
weights story is closed with procedurally ray-cast scenes: a floor plane,
box obstacles, and "forbidden" floor zones (the grass/no-entry class the
deployment feeds into zone layers). Classes:

  0 = background (sky), 1 = floor, 2 = forbidden zone, 3 = obstacle

Rendering is a tiny vectorized ray-caster (pinhole camera, plane + AABB
intersections) producing (rgb, depth, labels) with per-scene color tints,
lighting gradients, and pixel noise — enough variation that the net must
learn color+context, not a constant lookup.

The port's own copy of
``dddmr_navigation_tpu/perception/semantic_data.py`` (numpy only);
``tests/test_torch_semantic.py`` holds it to the original.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CameraIntrinsics(NamedTuple):
    fx: float = 80.0
    fy: float = 80.0
    cx: float = 64.0
    cy: float = 48.0
    height: int = 96
    width: int = 128


# nominal class colors (RGB in [0,1]); scenes tint + noise them
CLASS_COLORS = np.array([
    [0.55, 0.70, 0.90],   # 0 sky
    [0.45, 0.44, 0.42],   # 1 floor (asphalt gray)
    [0.25, 0.55, 0.20],   # 2 forbidden (grass green)
    [0.50, 0.33, 0.22],   # 3 obstacle (brown box)
], np.float32)


def render_scene(rng: np.random.Generator,
                 cam: CameraIntrinsics = CameraIntrinsics(),
                 n_boxes: int = 3, n_zones: int = 2,
                 cam_height: float = 1.0, pitch_deg: float = -12.0,
                 zones=None, pitch_jitter: float = 4.0):
    """Returns (rgb (H,W,3) f32, depth (H,W) f32 camera z-depth
    [0 = no return], labels (H,W) int32, zones [(cx, cy, sx, sy), ...],
    pose (origin (3,), pitch rad)). Pass ``zones`` to pin the forbidden
    rectangles (deterministic e2e scenes)."""
    H, W = cam.height, cam.width
    # pixel rays in camera frame (x right, y down, z forward)
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    d_cam = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                      np.ones_like(u, np.float32)], -1).astype(np.float32)
    d_norm = np.linalg.norm(d_cam, axis=-1)
    pitch = np.radians(pitch_deg + rng.uniform(-pitch_jitter, pitch_jitter))
    cp, sp = np.cos(pitch), np.sin(pitch)
    # world frame: x forward, y left, z up; camera at (0,0,h)
    dirs = np.stack([
        d_cam[..., 2] * cp - (-d_cam[..., 1]) * sp,
        -d_cam[..., 0],
        (-d_cam[..., 1]) * cp + d_cam[..., 2] * sp], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origin = np.array([0.0, 0.0, cam_height], np.float32)

    t_hit = np.full((H, W), np.inf, np.float32)
    labels = np.zeros((H, W), np.int32)          # sky

    # floor plane z=0
    dz = dirs[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_floor = np.where(dz < -1e-6, -origin[2] / dz, np.inf)
    floor_hit = t_floor < t_hit
    t_hit = np.where(floor_hit, t_floor, t_hit)
    labels = np.where(floor_hit, 1, labels)
    t_safe = np.where(np.isfinite(t_hit), t_hit, 0.0)
    hit_xy = origin[None, None, :2] + dirs[..., :2] * t_safe[..., None]

    # forbidden zones: rectangles on the floor
    if zones is None:
        zones = [(rng.uniform(2.0, 7.0), rng.uniform(-2.5, 2.5),
                  rng.uniform(0.8, 2.0), rng.uniform(0.8, 2.0))
                 for _ in range(n_zones)]
    for (cx, cy, sx, sy) in zones:
        in_zone = (floor_hit
                   & (np.abs(hit_xy[..., 0] - cx) <= sx / 2)
                   & (np.abs(hit_xy[..., 1] - cy) <= sy / 2))
        labels = np.where(in_zone, 2, labels)

    # box obstacles (AABB slab test)
    for _ in range(n_boxes):
        c = np.array([rng.uniform(2.0, 7.0), rng.uniform(-2.5, 2.5), 0.0])
        s = np.array([rng.uniform(0.3, 1.0), rng.uniform(0.3, 1.0),
                      rng.uniform(0.4, 1.4)])
        lo = c - [s[0] / 2, s[1] / 2, 0.0]
        hi = c + [s[0] / 2, s[1] / 2, s[2]]
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / dirs
            t0 = (lo[None, None, :] - origin[None, None, :]) * inv
            t1 = (hi[None, None, :] - origin[None, None, :]) * inv
        tmin = np.minimum(t0, t1).max(-1)
        tmax = np.maximum(t0, t1).min(-1)
        hit = (tmax >= tmin) & (tmax > 0) & (np.maximum(tmin, 0.0) < t_hit)
        tbox = np.where(tmin > 0, tmin, tmax)
        t_hit = np.where(hit, tbox, t_hit)
        labels = np.where(hit, 3, labels)

    # camera z-depth: t along the normalized ray ⇒ z_cam = t / |d_cam|
    # (d_cam has z = 1), the convention depth_image_to_points inverts
    depth_z = np.where(np.isfinite(t_hit), t_hit / d_norm, 0.0)

    # color: class base + per-scene tint + lighting gradient + noise
    tint = rng.uniform(-0.08, 0.08, (4, 3)).astype(np.float32)
    rgb = (CLASS_COLORS + tint)[labels]
    shade = (1.0 - 0.25 * np.clip(t_hit / 12.0, 0, 1))[..., None]
    rgb = np.where(np.isfinite(t_hit)[..., None], rgb * shade, rgb)
    rgb += rng.normal(0.0, 0.03, rgb.shape)
    return (np.clip(rgb, 0, 1).astype(np.float32),
            depth_z.astype(np.float32), labels, zones, (origin, pitch))


def make_batch(rng, n, cam: CameraIntrinsics = CameraIntrinsics()):
    rgbs, labels = [], []
    for _ in range(n):
        rgb, _, lab, _, _ = render_scene(rng, cam)
        rgbs.append(rgb)
        labels.append(lab)
    return np.stack(rgbs), np.stack(labels)


def miou(pred: np.ndarray, truth: np.ndarray, num_classes: int = 4):
    """Mean intersection-over-union over classes present in the truth."""
    ious = []
    for c in range(num_classes):
        t = truth == c
        p = pred == c
        union = np.logical_or(t, p).sum()
        if t.sum() == 0:
            continue
        ious.append(np.logical_and(t, p).sum() / max(union, 1))
    return float(np.mean(ious)) if ious else 0.0


def camera_to_world(cam_pts: np.ndarray, origin, pitch: float):
    """Map camera-frame points (x right, y down, z forward) to the
    renderer's world frame (x forward, y left, z up)."""
    cp, sp = np.cos(pitch), np.sin(pitch)
    R = np.array([[0.0, sp, cp],
                  [-1.0, 0.0, 0.0],
                  [0.0, -cp, sp]], np.float32)
    return cam_pts @ R.T + np.asarray(origin, np.float32)


def perspective_matrix(pts_src, pts_dst):
    """4-point homography (the reference's
    `cv2.getPerspectiveTransform`, `scripts/perspective_transform.py:52`)
    via the direct linear transform — no OpenCV. Returns (3, 3)."""
    pts_src = np.asarray(pts_src, np.float64)
    pts_dst = np.asarray(pts_dst, np.float64)
    A = []
    for (x, y), (u, v) in zip(pts_src, pts_dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
    b = pts_dst.reshape(-1)
    h = np.linalg.solve(np.asarray(A), b)
    return np.append(h, 1.0).reshape(3, 3).astype(np.float32)


def warp_nearest(img, M, out_h, out_w):
    """Inverse-map warp with nearest sampling (`cv2.warpPerspective`
    semantics for label masks). ``M`` maps src pixel → dst pixel."""
    Minv = np.linalg.inv(np.asarray(M, np.float64))
    u, v = np.meshgrid(np.arange(out_w), np.arange(out_h))
    ones = np.ones_like(u)
    src = np.einsum("ij,jhw->ihw", Minv,
                    np.stack([u, v, ones]).astype(np.float64))
    sx = src[0] / src[2]
    sy = src[1] / src[2]
    xi = np.round(sx).astype(np.int64)
    yi = np.round(sy).astype(np.int64)
    ok = (xi >= 0) & (xi < img.shape[1]) & (yi >= 0) & (yi < img.shape[0])
    out = np.zeros((out_h, out_w), img.dtype)
    out[ok] = img[yi[ok], xi[ok]]
    return out, ok


def bev_class_grid(class_mask, cam: CameraIntrinsics, cam_height: float,
                   pitch: float, x_range=(0.5, 8.0), y_range=(-4.0, 4.0),
                   resolution: float = 0.1):
    """Depth-FREE bird's-eye-view class grid: project each metric ground
    cell (z = 0 plane) into the image through the known camera model and
    sample the class mask — the calibrated ground-plane homography the
    reference's `perspective_transform.py` builds from hand-picked
    points, derived analytically from intrinsics + (height, pitch).

    Returns (labels (Ny, Nx) int32 [-1 = out of view], xs (Nx,), ys (Ny,))
    — e.g. cells of the forbidden class become no-entry zone points
    without a depth image.
    """
    xs = np.arange(x_range[0], x_range[1] + 1e-9, resolution)
    ys = np.arange(y_range[0], y_range[1] + 1e-9, resolution)
    gx, gy = np.meshgrid(xs, ys)
    world = np.stack([gx, gy, np.zeros_like(gx)], -1)
    cp, sp = np.cos(pitch), np.sin(pitch)
    # inverse of camera_to_world's rotation (columns were the cam basis)
    R = np.array([[0.0, sp, cp],
                  [-1.0, 0.0, 0.0],
                  [0.0, -cp, sp]], np.float64)
    cam_pts = (world - np.array([0.0, 0.0, cam_height])) @ R
    z = cam_pts[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = cam.fx * cam_pts[..., 0] / z + cam.cx
        v = cam.fy * cam_pts[..., 1] / z + cam.cy
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    ok = ((z > 0.05) & (ui >= 0) & (ui < cam.width)
          & (vi >= 0) & (vi < cam.height))
    out = np.full(gx.shape, -1, np.int32)
    out[ok] = np.asarray(class_mask)[vi[ok], ui[ok]]
    return out, xs, ys
