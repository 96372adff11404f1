"""19-class (Mapillary-profile) procedural street scenes.

The reference deploys DDRNet23-slim trained on Mapillary-class data and
ships the class list as `data/colors_mapillary.csv` (row order = class
id, `trt_interface.py` argmax ids). Real camera corpora cannot ship in
this environment, so the training distribution is a procedural street
renderer emitting the SAME 19 classes: sidewalk/parking/terrain ground
patches, walls/fences/guardrails, poles with traffic signs, vegetation,
persons/riders, and the vehicle family (car/truck/bus/caravan/
motorcycle/bicycle) with license plates — per-instance colors sampled
from class-plausible distributions (vehicles get arbitrary hues, people
arbitrary clothing) so the net must learn geometry+context, not a color
lookup.

Generator-independent evaluation: `TRAIN_PRESET` and `EVAL_PRESET` are
DISJOINT scene-family configurations — non-overlapping camera pitch and
height ranges, a different layout family (uniform scatter vs curb-
aligned street rows), different tint/noise levels — so the held-out
score measures transfer across generator configurations, not memory of
one generator (VERDICT r3 item 6).

The port's own copy of
``dddmr_navigation_tpu/perception/semantic_scene19.py`` (numpy only);
``tests/test_torch_semantic.py`` holds it to the original.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# class ids by CSV row order (colors_mapillary.csv)
SIDEWALK, PARKING, WALL, FENCE, GUARDRAIL, POLE, TRAFFICSIGN, VEGETATION, \
    TERRAIN, SKY, PERSON, RIDER, CAR, TRUCK, BUS, CARAVAN, MOTORCYCLE, \
    BICYCLE, LICENSEPLATE = range(19)

CLASS_NAMES = ["SIDEWALK", "PARKING", "WALL", "FENCE", "GUARDRAIL", "POLE",
               "TRAFFICSIGN", "VEGETATION", "TERRAIN", "SKY", "PERSON",
               "RIDER", "CAR", "TRUCK", "BUS", "CARAVAN", "MOTORCYCLE",
               "BICYCLE", "LICENSEPLATE"]


@dataclass(frozen=True)
class ScenePreset:
    """One generator configuration (a scene FAMILY)."""
    name: str
    layout: str                 # "scatter" | "street"
    pitch_deg: tuple            # (lo, hi) — train/eval ranges DISJOINT
    cam_height: tuple           # (lo, hi) — disjoint
    n_objects: tuple            # (lo, hi)
    tint: float                 # per-scene color tint amplitude
    noise: float                # pixel noise sigma
    light_from_left: bool


TRAIN_PRESET = ScenePreset(
    name="train_scatter", layout="scatter", pitch_deg=(-13.0, -3.0),
    cam_height=(1.1, 1.7), n_objects=(6, 13), tint=0.08, noise=0.03,
    light_from_left=True)

# disjoint family: curb-aligned street rows, steeper+higher camera,
# hotter tint/noise, opposite lighting
EVAL_PRESET = ScenePreset(
    name="eval_street", layout="street", pitch_deg=(-18.0, -14.0),
    cam_height=(1.8, 2.2), n_objects=(8, 15), tint=0.12, noise=0.05,
    light_from_left=False)


def _class_color(rng, cls):
    """Per-instance plausible color (NOT the display palette)."""
    def around(base, spread=0.06):
        return np.clip(np.asarray(base) + rng.uniform(-spread, spread, 3),
                       0, 1)
    if cls in (CAR, TRUCK, BUS, CARAVAN, MOTORCYCLE):
        return rng.uniform(0.05, 0.95, 3)           # arbitrary paint
    if cls in (PERSON, RIDER):
        return rng.uniform(0.05, 0.9, 3)            # arbitrary clothing
    table = {
        SIDEWALK: [0.52, 0.51, 0.50], PARKING: [0.35, 0.35, 0.37],
        WALL: [0.55, 0.47, 0.40], FENCE: [0.45, 0.32, 0.20],
        GUARDRAIL: [0.70, 0.70, 0.72], POLE: [0.40, 0.40, 0.42],
        TRAFFICSIGN: [0.85, 0.75, 0.10], VEGETATION: [0.20, 0.45, 0.15],
        TERRAIN: [0.45, 0.55, 0.25], SKY: [0.55, 0.70, 0.90],
        BICYCLE: [0.15, 0.15, 0.18], LICENSEPLATE: [0.90, 0.90, 0.85],
    }
    return around(table[cls])


def _object_boxes(rng, cls, pos):
    """AABBs (lo, hi, class) composing one object instance at pos=(x,y)."""
    x, y = pos

    def box(cx, cy, sx, sy, z0, z1, c):
        return (np.array([cx - sx / 2, cy - sy / 2, z0]),
                np.array([cx + sx / 2, cy + sy / 2, z1]), c)
    if cls == WALL:
        return [box(x, y, rng.uniform(2, 6), 0.3, 0, rng.uniform(1.5, 2.5),
                    WALL)]
    if cls == FENCE:
        return [box(x, y, rng.uniform(2, 5), 0.1, 0, rng.uniform(0.8, 1.2),
                    FENCE)]
    if cls == GUARDRAIL:
        return [box(x, y, rng.uniform(2, 5), 0.15, 0.3, 0.75, GUARDRAIL)]
    if cls == POLE:
        return [box(x, y, 0.15, 0.15, 0, rng.uniform(2.5, 4.0), POLE)]
    if cls == TRAFFICSIGN:
        h = rng.uniform(2.2, 3.0)
        return [box(x, y, 0.12, 0.12, 0, h, POLE),
                box(x, y, 0.7, 0.1, h, h + 0.7, TRAFFICSIGN)]
    if cls == VEGETATION:
        return [box(x, y, rng.uniform(0.8, 2.0), rng.uniform(0.8, 2.0), 0,
                    rng.uniform(1.0, 3.0), VEGETATION)]
    if cls == PERSON:
        return [box(x, y, 0.45, 0.3, 0, rng.uniform(1.5, 1.9), PERSON)]
    if cls == RIDER:
        return [box(x, y, 0.4, 1.7, 0.5, rng.uniform(1.6, 1.9), RIDER),
                box(x, y, 0.3, 1.8, 0, 0.9, BICYCLE)]
    if cls == CAR:
        sx, sy = 1.8, rng.uniform(3.8, 4.6)
        return [box(x, y, sx, sy, 0, 1.45, CAR),
                box(x, y - sy / 2 - 0.02, 0.5, 0.06, 0.4, 0.55,
                    LICENSEPLATE)]
    if cls == TRUCK:
        return [box(x, y, 2.4, rng.uniform(6, 8), 0, rng.uniform(2.8, 3.4),
                    TRUCK)]
    if cls == BUS:
        return [box(x, y, 2.5, rng.uniform(9, 12), 0, 3.1, BUS)]
    if cls == CARAVAN:
        return [box(x, y, 2.2, rng.uniform(4.5, 6), 0, 2.6, CARAVAN)]
    if cls == MOTORCYCLE:
        return [box(x, y, 0.7, 2.0, 0, 1.2, MOTORCYCLE)]
    if cls == BICYCLE:
        return [box(x, y, 0.4, 1.8, 0, 1.1, BICYCLE)]
    raise ValueError(cls)


_OBJECT_CLASSES = [WALL, FENCE, GUARDRAIL, POLE, TRAFFICSIGN, VEGETATION,
                   PERSON, RIDER, CAR, TRUCK, BUS, CARAVAN, MOTORCYCLE,
                   BICYCLE]

_WINDOW = np.array([0.10, 0.12, 0.18], np.float32)
_TIRE = np.array([0.06, 0.06, 0.07], np.float32)
_SKIN = np.array([0.82, 0.62, 0.50], np.float32)


def _instance_shading(rng, cls, base, hp, lo, hi):
    """Class-distinctive surface structure on the hit points of one box:
    the visual cues real deployments separate the vehicle family by —
    window bands (bus: periodic windows full-length; truck: cab-front
    only; car: one canopy band; caravan: one small porthole), tires near
    the ground, skin-tone heads on persons/riders. Random paint colors
    alone made CAR/TRUCK/CARAVAN mutually indistinguishable (per-class
    IoU ≈ 0.0–0.2); size is confounded with distance in a pinhole view,
    so the classes need surface cues, exactly like real imagery."""
    n = len(hp)
    col = np.broadcast_to(base, (n, 3)).copy()
    size = np.maximum(hi - lo, 1e-6)
    rel = (hp - lo[None, :]) / size[None, :]          # (n,3) in [0,1]
    long_axis = int(np.argmax(size[:2]))
    relz = rel[:, 2]
    rell = rel[:, long_axis]
    if cls in (CAR, TRUCK, BUS, CARAVAN):
        win = (relz > 0.55) & (relz < 0.88)
        if cls == BUS:
            win &= (np.mod(rell * 8.0, 1.0) < 0.62)   # periodic windows
        elif cls == TRUCK:
            win &= rell < 0.22                        # cab only
        elif cls == CARAVAN:
            win &= (rell > 0.35) & (rell < 0.55)      # one porthole
            col[:] = 0.65 + 0.3 * (base - 0.5)        # pale body
        col[win] = _WINDOW
        col[relz < 0.16] = _TIRE                      # wheels/skirt
    elif cls in (MOTORCYCLE, BICYCLE):
        col[relz < 0.5] = _TIRE
    elif cls in (PERSON, RIDER):
        col[relz > 0.82] = _SKIN                      # head
        col[(relz > 0.40) & (relz <= 0.82)] = base    # torso
        col[relz <= 0.40] = base * 0.55               # legs darker
    elif cls == POLE:
        col[:] = [0.42, 0.43, 0.46]                   # consistent steel
    return col


def render_scene19(rng: np.random.Generator, height=240, width=320,
                   preset: ScenePreset = TRAIN_PRESET,
                   return_pose: bool = False):
    """Ray-cast one scene → (rgb (H,W,3) f32, depth_z (H,W) f32,
    labels (H,W) int32[, (pitch_rad, cam_height) with return_pose —
    the camera pose the e2e consumers need to map detections to world])."""
    H, W = height, width
    fx = fy = 0.63 * W
    cx, cy = W / 2.0, H / 2.0
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    d_cam = np.stack([(u - cx) / fx, (v - cy) / fy,
                      np.ones_like(u, np.float32)], -1).astype(np.float32)
    d_norm = np.linalg.norm(d_cam, axis=-1)
    pitch = np.radians(rng.uniform(*preset.pitch_deg))
    cp, sp = np.cos(pitch), np.sin(pitch)
    dirs = np.stack([
        d_cam[..., 2] * cp - (-d_cam[..., 1]) * sp,
        -d_cam[..., 0],
        (-d_cam[..., 1]) * cp + d_cam[..., 2] * sp], -1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    origin = np.array([0.0, 0.0, rng.uniform(*preset.cam_height)],
                      np.float32)

    t_hit = np.full((H, W), np.inf, np.float32)
    labels = np.full((H, W), SKY, np.int32)
    inst_color = np.zeros((H, W, 3), np.float32)
    inst_color[:] = _class_color(rng, SKY)

    # ground: sidewalk base + parking/terrain patches
    dz = dirs[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_floor = np.where(dz < -1e-6, -origin[2] / dz, np.inf)
    floor_hit = np.isfinite(t_floor)
    t_hit = np.where(floor_hit, t_floor, t_hit)
    labels = np.where(floor_hit, SIDEWALK, labels)
    c_sidewalk = _class_color(rng, SIDEWALK)
    inst_color[floor_hit] = c_sidewalk
    t_safe = np.where(np.isfinite(t_hit), t_hit, 0.0)
    hit_xy = origin[None, None, :2] + dirs[..., :2] * t_safe[..., None]

    for patch_cls in (PARKING, TERRAIN, TERRAIN):
        if preset.layout == "street":
            cxp = rng.uniform(4, 18)
            cyp = rng.choice([-1, 1]) * rng.uniform(3.0, 6.0)
        else:
            cxp, cyp = rng.uniform(2, 14), rng.uniform(-5, 5)
        sxp, syp = rng.uniform(2, 6), rng.uniform(2, 5)
        inp = (floor_hit & (np.abs(hit_xy[..., 0] - cxp) <= sxp / 2)
               & (np.abs(hit_xy[..., 1] - cyp) <= syp / 2))
        labels = np.where(inp, patch_cls, labels)
        inst_color[inp] = _class_color(rng, patch_cls)

    # objects
    n_obj = rng.integers(*preset.n_objects)
    boxes = []
    for _ in range(n_obj):
        cls = int(rng.choice(_OBJECT_CLASSES))
        if preset.layout == "street":
            # curb-aligned rows: vehicles parked at lateral bands,
            # persons/bikes on the sidewalk band, fixtures at the curb
            if cls in (CAR, TRUCK, BUS, CARAVAN):
                pos = (rng.uniform(5, 22), rng.choice([-1, 1])
                       * rng.uniform(2.8, 3.8))
            elif cls in (PERSON, RIDER, BICYCLE, MOTORCYCLE):
                pos = (rng.uniform(3, 15), rng.choice([-1, 1])
                       * rng.uniform(0.5, 1.8))
            else:
                pos = (rng.uniform(4, 20), rng.choice([-1, 1])
                       * rng.uniform(4.2, 6.0))
        else:
            pos = (rng.uniform(2.5, 14.0), rng.uniform(-5.0, 5.0))
        boxes.extend(_object_boxes(rng, cls, pos))

    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / dirs
    for lo, hi, cls in boxes:
        t0 = (lo[None, None, :] - origin[None, None, :]) * inv
        t1 = (hi[None, None, :] - origin[None, None, :]) * inv
        tmin = np.minimum(t0, t1).max(-1)
        tmax = np.maximum(t0, t1).min(-1)
        tbox = np.where(tmin > 0, tmin, tmax)
        hit = (tmax >= tmin) & (tmax > 0) & (tbox < t_hit) & (tbox > 0)
        t_hit = np.where(hit, tbox, t_hit)
        labels = np.where(hit, cls, labels)
        base = _class_color(rng, cls)
        if hit.any():
            hp = origin[None, :] + dirs[hit] * tbox[hit][:, None]
            inst_color[hit] = _instance_shading(rng, cls, base, hp, lo, hi)

    depth_z = np.where(np.isfinite(t_hit), t_hit / d_norm, 0.0)

    tint = rng.uniform(-preset.tint, preset.tint, 3).astype(np.float32)
    rgb = inst_color + tint
    # lateral lighting gradient (direction differs between presets)
    grad = np.linspace(-0.12, 0.12, W, dtype=np.float32)
    if not preset.light_from_left:
        grad = grad[::-1]
    rgb = rgb * (1.0 + grad[None, :, None])
    shade = (1.0 - 0.25 * np.clip(t_safe / 25.0, 0, 1))[..., None]
    rgb = np.where(np.isfinite(t_hit)[..., None], rgb * shade, rgb)
    rgb = rgb + rng.normal(0.0, preset.noise, rgb.shape)
    out = (np.clip(rgb, 0, 1).astype(np.float32),
           depth_z.astype(np.float32), labels)
    if return_pose:
        return out + ((float(pitch), float(origin[2])),)
    return out


def make_batch19(rng, n, height=240, width=320,
                 preset: ScenePreset = TRAIN_PRESET):
    rgbs, labs = [], []
    for _ in range(n):
        rgb, _, lab = render_scene19(rng, height, width, preset)
        rgbs.append(rgb)
        labs.append(lab)
    return np.stack(rgbs), np.stack(labs)
