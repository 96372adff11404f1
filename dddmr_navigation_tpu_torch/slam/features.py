"""LOAM feature extraction, the counterpart of
``dddmr_navigation_tpu/slam/features.py`` (lego_loam's
``FeatureAssociation`` front half,
`lego_loam_bor/src/featureAssociation.cpp:318-520`).

Everything stays in the (V, H) range-image layout: an 11-tap smoothness
along the ring, vectorized occlusion and parallel-beam marking, and a
greedy pick loop per (ring, sector) lane. The 16 × 6 lanes run as one
batched masked ``argmax`` per pick (``torch.argmax`` returns the first
maximum, as ``jnp.argmax`` does), with a ±5 column suppression band.

Bit for bit with the JAX package's jitted frontend: XLA on the CPU fuses
the smoothness sum's first add, ``-10·r + roll(r, 1)``, into one FMA, and
the curvature ranks the picks, so the port does too. The compaction into
static shapes takes the first k true indices without a host read
(``ops.compaction.first_k_true_indices``, as ``jnp.nonzero(size=)``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dddmr_navigation_tpu_torch.config import SlamConfig
from dddmr_navigation_tpu_torch.ops.compaction import first_k_true_indices
from dddmr_navigation_tpu_torch.rounding import f32, fma
from dddmr_navigation_tpu_torch.slam.projection import RangeImage

N_SECTORS = 6
CORNER_PICKS = 20
FLAT_PICKS = 4


class FeatureSet(NamedTuple):
    sharp: torch.Tensor        # (max_sharp, 3)
    sharp_mask: torch.Tensor
    less_sharp: torch.Tensor   # (max_less_sharp, 3)
    less_sharp_mask: torch.Tensor
    flat: torch.Tensor         # (max_flat, 3)
    flat_mask: torch.Tensor
    less_flat: torch.Tensor    # (max_less_flat, 3)
    less_flat_mask: torch.Tensor
    # ring (scan-row) index per target feature, constraining the
    # correspondence picks (`featureAssociation.cpp:633-676`, `:751-806`)
    less_sharp_ring: torch.Tensor   # (max_less_sharp,) i32
    less_flat_ring: torch.Tensor    # (max_less_flat,) i32
    # True where a less-flat pick is a ground pixel (map/ground split)
    less_flat_ground: torch.Tensor  # (max_less_flat,) bool


def smoothness(rng, valid):
    """`calculateSmoothness`: curvature over ±5 ring neighbours, and
    whether the 11-tap window is all valid. The first add is one FMA, as
    XLA on the CPU contracts ``-10·r + roll(r, 1)``."""
    acc = fma(-10.0, rng, torch.roll(rng, 1, 1)) + torch.roll(rng, -1, 1)
    win_ok = valid & torch.roll(valid, 1, 1) & torch.roll(valid, -1, 1)
    for off in range(2, 6):
        acc = acc + torch.roll(rng, off, 1) + torch.roll(rng, -off, 1)
        win_ok = win_ok & torch.roll(valid, off, 1) \
            & torch.roll(valid, -off, 1)
    return acc * acc, win_ok


def occlusion_mask(rng, valid):
    """`markOccludedPoints`: pixels beside a ≥ 0.3 m range step are banned
    on the nearer side (a 6-wide band), and parallel-beam pixels (both
    neighbours differ by > 2 % of the range). True where picking is
    forbidden."""
    nxt = torch.roll(rng, -1, 1)
    both = valid & torch.roll(valid, -1, 1)
    occl_here = both & (rng - nxt > f32(0.3))
    occl_next = both & (nxt - rng > f32(0.3))
    banned = occl_here.clone()
    for off in range(1, 6):
        banned |= torch.roll(occl_here, off, 1)
    for off in range(1, 7):
        banned |= torch.roll(occl_next, off, 1)
    d_prev = torch.abs(torch.roll(rng, 1, 1) - rng)
    d_next = torch.abs(nxt - rng)
    tol = f32(0.02) * rng
    parallel = valid & (d_prev > tol) & (d_next > tol)
    return banned | parallel


def _pick_lane(curv, elig, maximize: bool, n_picks: int, suppress: int = 5):
    """The greedy pick loop on every lane at once: ``curv`` and ``elig``
    (L, H); ``n_picks`` masked argmax (argmin) picks per lane, each
    suppressing ±``suppress`` columns. Returns (L, H) pick order (−1 not
    picked, else 0..n_picks−1)."""
    lanes, h = curv.shape
    score_src = curv if maximize else -curv
    col = torch.arange(h, device=curv.device)
    order = torch.full((lanes, h), -1, dtype=torch.int32, device=curv.device)
    neg_inf = torch.full((), float("-inf"), device=curv.device)
    for k in range(n_picks):
        score = torch.where(elig, score_src, neg_inf)
        i = torch.argmax(score, dim=1)
        best = score.gather(1, i[:, None])[:, 0]
        ok = torch.isfinite(best)
        order.scatter_(1, i[:, None], torch.where(
            ok, k, order.gather(1, i[:, None])[:, 0]).to(torch.int32)[:, None])
        band = torch.abs(col[None, :] - i[:, None]) <= suppress
        elig = elig & ~(band & ok[:, None])
    return order


def _compact(pts, mask, size: int):
    """Static-shape compaction of masked (V, H) picks into (size, 3):
    (points, valid, ring of each pick)."""
    v, h = mask.shape
    idx = first_k_true_indices(mask.reshape(-1), size)
    ok = idx >= 0
    src = torch.clamp(idx, 0, v * h - 1)
    p = pts.reshape(-1, 3)[src]
    ring = torch.where(ok, torch.div(src, h, rounding_mode="floor"),
                       -1).to(torch.int32)
    return torch.where(ok[:, None], p, 0.0), ok, ring


def extract_features(cfg: SlamConfig, img: RangeImage) -> FeatureSet:
    """`extractFeatures` (`featureAssociation.cpp:381-520`)."""
    v, h = img.valid.shape
    dev = img.valid.device
    curv, win_ok = smoothness(img.rng, img.valid)
    banned = occlusion_mask(img.rng, img.valid)

    col = torch.arange(h, device=dev)
    sector = torch.div(col * N_SECTORS, h, rounding_mode="floor")
    in_sector = sector[None, :] == torch.arange(N_SECTORS,
                                                device=dev)[:, None]

    corner_elig = (img.segment_mask & ~img.ground & win_ok & ~banned
                   & (curv > f32(cfg.edge_threshold)))
    flat_elig = (img.ground & img.valid & win_ok & ~banned
                 & (curv < f32(cfg.surf_threshold)))

    def picks(elig, maximize, n):
        lanes = (elig[:, None, :] & in_sector[None]).reshape(
            v * N_SECTORS, h)
        c = curv[:, None, :].expand(v, N_SECTORS, h).reshape(
            v * N_SECTORS, h)
        return _pick_lane(c, lanes, maximize, n).reshape(
            v, N_SECTORS, h).amax(dim=1)

    corner_order = picks(corner_elig, True, CORNER_PICKS)
    flat_order = picks(flat_elig, False, FLAT_PICKS)
    sharp_m = corner_order >= 0
    sharp2_m = sharp_m & (corner_order < 2)
    flat_m = flat_order >= 0
    # less-flat: every segment/ground pixel not picked as a corner,
    # decimated ×4 along the ring
    less_flat_m = ((img.segment_mask | img.ground) & img.valid
                   & ~sharp_m & (col % 4 == 0)[None, :])

    sharp, sm, _ = _compact(img.pts, sharp2_m, cfg.max_sharp)
    less_sharp, lsm, lsr = _compact(img.pts, sharp_m, cfg.max_less_sharp)
    flat, fm, _ = _compact(img.pts, flat_m, cfg.max_flat)
    less_flat, lfm, lfr = _compact(img.pts, less_flat_m, cfg.max_less_flat)
    lf_idx = torch.clamp(first_k_true_indices(less_flat_m.reshape(-1),
                                              cfg.max_less_flat), min=0)
    lf_ground = img.ground.reshape(-1)[lf_idx] & lfm
    return FeatureSet(sharp, sm, less_sharp, lsm, flat, fm, less_flat, lfm,
                      lsr, lfr, lf_ground)
