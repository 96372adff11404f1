"""The least time the card could take for a kernel call on its inputs:
the bytes and the distance count of ``chip_smoke.py::bound_us``'s "data"
arithmetic, frozen here, and a count of the collision tests no cull can
skip.

Published peaks of one NVIDIA H100 SXM (the data sheet, dense, at the
700 W power limit): 67 TFLOP/s in f32 outside the tensor cores, 3.35 TB/s
of HBM. A call's bound is the larger of the operations its inputs need
over the first and the bytes they need over the second.

* ``swept_box_hits``: 21 flops a point-box test (three 3-term
  projections, three compares) of a valid rollout step against each valid
  obstacle inside the step's bounding sphere (its box center, radius the
  half diagonal |h|): no cull can decide those pairs without the exact
  test, while a pair outside the sphere can be culled unseen (the "data"
  count of every valid pair read 95 % in the fused cell on the H100: the
  kernel's tile cull beats it). Bytes: the
  step mask, the axes and centers (48 bytes) of valid steps, each
  obstacle and its flag (13 bytes), the (B, S) output.
* ``masked_min_distance``: 8 flops a distance of an unmasked query to a
  valid point (three differences, three products, two adds); bytes: the
  query mask, each unmasked query (12), the point mask, each valid point
  (12), the (B, Q) f32 output.

Both counts are of what these inputs need, so no implementation that
tests what it must can read above 100 %.
"""
from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def sphere_pairs(axes, projc, step_valid, obs, obs_valid, half,
                 pairs_per_pass: int = 1 << 24) -> float:
    """(valid step, valid obstacle) pairs whose obstacle lies within the
    step box's bounding sphere: center A^T c (the rows of ``axes`` are the
    box's unit axes, ``projc`` their projections of the center), radius
    the half diagonal."""
    import torch
    r2 = float(sum(float(h) ** 2 for h in half))
    center = torch.einsum("bsnkj,bsnk->bsnj", axes, projc)
    b = center.shape[0]
    center = center.reshape(b, -1, 3)
    valid = step_valid.reshape(b, -1)
    pts = torch.where(obs_valid[..., None], obs, torch.inf)
    total = 0
    rows_per_pass = max(1, pairs_per_pass // (b * max(1, pts.shape[1])))
    for r0 in range(0, center.shape[1], rows_per_pass):
        c = center[:, r0:r0 + rows_per_pass]
        d = c[:, :, None, :] - pts[:, None, :, :]
        inside = (d * d).sum(-1) <= r2
        total += int((inside & valid[:, r0:r0 + rows_per_pass, None]).sum())
    return float(total)


def bound_us(name: str, args) -> tuple:
    """(least µs, "operations" or "bytes": which sets it) of one call."""
    if name == "swept_box_hits":
        axes, projc, step_valid, obs, obs_valid, half = args
        rows = step_valid.sum(dim=(1, 2)).double()
        ops = 21.0 * sphere_pairs(axes, projc, step_valid, obs, obs_valid,
                                  half)
        nbytes = (step_valid.numel() + 48.0 * float(rows.sum())
                  + 13.0 * obs_valid.numel()
                  + step_valid.shape[0] * step_valid.shape[1])
    elif name == "masked_min_distance":
        _queries, q_mask, _points, p_mask = args
        nq = q_mask.sum(1).double()
        ops = 8.0 * float((nq * p_mask.sum(1).double()).sum())
        nbytes = (q_mask.numel() + 12.0 * float(nq.sum()) + p_mask.numel()
                  + 12.0 * float(p_mask.sum()) + 4.0 * q_mask.numel())
    else:
        raise KeyError(f"no bound for {name!r}")
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e6, ("operations" if t_ops >= t_bytes
                                       else "bytes")
