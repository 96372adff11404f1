"""Auxiliary perception layers and their composition: the path-blocked
strategy, speed-limit zones, no-entry zones and the min-composed stack.

Counterpart of ``dddmr_navigation_tpu/perception/layers.py`` (reference
plugins `path_blocked_strategy.cpp`, `speed_limit_layer.cpp`,
`no_entry_layer.cpp`), batched over robots where the JAX function is a
per-robot device function. Each layer is a masked reduction.

Rounding: the JAX package calls ``path_blocked``, ``no_entry_dgraph`` and
the host session's ``speed_limit_at`` eagerly, op by op, so the squared
distances here round each product before the sum. The fused tick calls
``speed_limit_at`` inside its jitted program, where XLA on the CPU makes
the sum a chain of fused multiply-adds: ``fma=True`` rounds that way.
"""
from __future__ import annotations

import torch

from navbench.reference.rounding import fma_dot, sqrt_rn


def _sq(d):
    """Σ d² over the last (size 3 or 2) axis, each product rounded, summed
    left to right: an eager ``jnp.sum(d * d, -1)``."""
    out = d[..., 0] * d[..., 0]
    for i in range(1, d.shape[-1]):
        out = out + d[..., i] * d[..., i]
    return out


def path_blocked(prune, obstacles, obs_valid, check_radius: float = 0.3):
    """`PathBlockedStrategy::selfMark` (`path_blocked_strategy.cpp:56-101`):
    PATH_BLOCKED_WAIT when any observation point lies within
    ``check_radius`` of a forward prune-plan pose (intensity ≥ 0).

    prune: a ``PrunePlan`` of (B, P) poses; obstacles (B, M, 3), obs_valid
    (B, M). Returns (B,) bool."""
    fwd = prune.valid & (prune.intensity >= 0.0)
    d2 = _sq(prune.positions[:, :, None, :] - obstacles[:, None, :, :])
    ok = fwd[:, :, None] & obs_valid[:, None, :]
    hit = (torch.where(ok, d2, torch.inf) <= check_radius ** 2).flatten(1)
    return hit.any(dim=1) & (prune.valid.sum(dim=1) > 0)


def speed_limit_at(robot_pos, zone_points, zone_valid, zone_speed,
                   match_radius: float = 0.5, fma: bool = False):
    """`SpeedLimitLayer::selfMark` (`speed_limit_layer.cpp:222-300`): inside
    a speed zone (its nearest zone point within ``match_radius``, the first
    of equal minima as ``jnp.argmin`` takes it) the allowed linear speed is
    that point's; -1 means unlimited.

    robot_pos (B, 3); zone_points (Z, 3), zone_valid (Z,), zone_speed (Z,)
    shared by all robots. Returns (B,) f32."""
    d = zone_points[None, :, :] - robot_pos[:, None, :]
    d2 = fma_dot(d, d) if fma else _sq(d)
    d2 = torch.where(zone_valid, d2, torch.inf)
    i = torch.argmin(d2, dim=1)
    inside = d2.gather(1, i[:, None])[:, 0] <= match_radius ** 2
    return torch.where(inside, zone_speed[i], -1.0)


def no_entry_dgraph(ground, ground_valid, zone_points, zone_valid,
                    inflation_distance: float, max_obstacle_distance: float):
    """`NoEntryLayer::selfMark` (`no_entry_layer.cpp:225-290`): the XY
    distance to the nearest zone point for every ground node within
    ``inflation_distance`` of the zones, ``max_obstacle_distance``
    elsewhere. A map property: (G,) for the shared ground."""
    d2 = _sq(ground[:, None, :2] - zone_points[None, :, :2])
    ok = ground_valid[:, None] & zone_valid[None, :]
    dmin = sqrt_rn(torch.where(ok, d2, torch.inf).amin(dim=1))
    return torch.where(dmin <= inflation_distance, dmin,
                       max_obstacle_distance)


def min_dgraph(*dgraphs):
    """`StackedPerception::get_min_dGraphValue`
    (`stacked_perception.cpp:114-126`): the elementwise min over layers."""
    out = dgraphs[0]
    for d in dgraphs[1:]:
        out = torch.minimum(out, d)
    return out
