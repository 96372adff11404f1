"""The 6-DOF particle filter of a fleet of robots, as batched tensor ops.

Counterpart of ``dddmr_navigation_tpu/state_estimation/pf.py`` (the
reference's ``mcl_3dl::ParticleFilter``, `include/mcl_3dl/pf.h:155-450`):
every tensor has a leading robot axis B and a particle axis N.

Random numbers are kept apart from their use: each random step takes its
draws as tensors (unit normals, and the resampling's unit uniform), so a
caller can feed the filter from a ``torch.Generator`` (:func:`draw_mcl`)
or replay another generator's draws.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from dddmr_navigation_tpu_torch.config import MCLConfig
from dddmr_navigation_tpu_torch.geometry import (
    quat_conjugate, quat_from_axis_angle, quat_from_rpy, quat_from_yaw,
    quat_multiply_fma,
    quat_normalize, quat_rotate_fma, rpy_from_quat)
from dddmr_navigation_tpu_torch.rounding import (
    cumsum_xla, exp_fma, fma, fma_norm, recip)


class PFState(NamedTuple):
    """Particle sets, (B, N, ...)."""
    pos: torch.Tensor                 # (B, N, 3)
    quat: torch.Tensor                # (B, N, 4) (x, y, z, w)
    prob: torch.Tensor                # (B, N), each row sums to 1
    odom_err_integ_lin: torch.Tensor  # (B, N, 3)
    odom_err_integ_ang: torch.Tensor  # (B, N, 3)
    noise_ll: torch.Tensor            # (B, N) odometry noise coefficients,
    noise_la: torch.Tensor            # refreshed every update
    noise_aa: torch.Tensor            # (`mcl_3dl.cpp:222-231`)
    noise_al: torch.Tensor


class MCLDraws(NamedTuple):
    """The random draws of one MCL update of every robot."""
    resample_u: torch.Tensor          # (B,) unit uniform in [0, 1)
    resample_pos: torch.Tensor        # (B, N, 3) unit normals
    resample_rpy: torch.Tensor        # (B, N, 3)
    expand_pos: torch.Tensor          # (B, N, 3)
    expand_rpy: torch.Tensor          # (B, N, 3)
    odom: torch.Tensor                # (B, N, 4) ll, la, aa, al


def draw_mcl(generator: torch.Generator, b: int, n: int,
             device) -> MCLDraws:
    """One update's draws for ``b`` robots of ``n`` particles, made on
    ``device`` from ``generator`` (which must live on that device)."""
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)
    return MCLDraws(
        resample_u=torch.rand((b,), generator=generator, device=device),
        resample_pos=normal(b, n, 3), resample_rpy=normal(b, n, 3),
        expand_pos=normal(b, n, 3), expand_rpy=normal(b, n, 3),
        odom=normal(b, n, 4))


def _sigma(cfg: MCLConfig, prefix: str):
    return [getattr(cfg, f"{prefix}_{a}")
            for a in ("x", "y", "z", "roll", "pitch", "yaw")]


def _pose_noise(pos_n, rpy_n, sigma6):
    """Gaussian pose noise from unit normals: (…, 3) translation and the
    (…, 4) quaternion of the rpy noise."""
    dp = torch.stack([pos_n[..., k] * sigma6[k] for k in range(3)], dim=-1)
    r, p, y = (rpy_n[..., k] * sigma6[3 + k] for k in range(3))
    return dp, quat_from_rpy(r, p, y)


def init_particles(cfg: MCLConfig, init_pos, init_quat, pos_n,
                   rpy_n) -> PFState:
    """`ParticleFilter::init`: a Gaussian cloud with the ``init_var_*``
    sigmas around each robot's pose (B, 3)/(B, 4); ``pos_n`` and ``rpy_n``
    are (B, N, 3) unit normals."""
    b, n = pos_n.shape[:2]
    dp, dq = _pose_noise(pos_n, rpy_n, _sigma(cfg, "init_var"))
    pos = init_pos[:, None, :] + dp
    quat = quat_normalize(quat_multiply_fma(dq, init_quat[:, None, :].expand(
        b, n, 4)))
    z3 = torch.zeros((b, n, 3), device=pos.device)
    z1 = torch.zeros((b, n), device=pos.device)
    return PFState(pos=pos, quat=quat,
                   prob=torch.full((b, n), 1.0 / n, device=pos.device),
                   odom_err_integ_lin=z3, odom_err_integ_ang=z3,
                   noise_ll=z1, noise_la=z1, noise_aa=z1, noise_al=z1)


def predict_diff_drive(state: PFState, rel_trans, rel_quat, rel_angle, dt,
                       cfg: MCLConfig) -> PFState:
    """The differential-drive motion model over every particle
    (`motion_prediction_model_differential_drive.h:57-68`). rel_trans
    (B, 3), rel_quat (B, 4), rel_angle (B,), dt a () tensor."""
    rel_norm = fma_norm(rel_trans)                                # (B,)
    zero = torch.zeros_like(state.noise_al)
    diff = (rel_trans[:, None, :] * (1.0 + state.noise_ll)[..., None]
            + torch.stack([state.noise_al * rel_angle[:, None], zero, zero],
                          dim=-1))
    integ_lin = state.odom_err_integ_lin + (diff - rel_trans[:, None, :])
    pos = state.pos + quat_rotate_fma(state.quat, diff)
    yaw_diff = (state.noise_la * rel_norm[:, None]
                + state.noise_aa * rel_angle[:, None])
    z0 = torch.zeros_like(yaw_diff)
    dq = quat_from_axis_angle(torch.stack([z0, z0, z0 + 1.0], dim=-1),
                              yaw_diff)
    quat = quat_normalize(quat_multiply_fma(quat_multiply_fma(dq, state.quat),
                                        rel_quat[:, None, :]))
    integ_ang = state.odom_err_integ_ang + torch.stack(
        [zero, zero, yaw_diff], dim=-1)
    integ_lin = integ_lin * (1.0 - dt * recip(cfg.odom_err_integ_lin_tc))
    integ_ang = integ_ang * (1.0 - dt * recip(cfg.odom_err_integ_ang_tc))
    return state._replace(pos=pos, quat=quat, odom_err_integ_lin=integ_lin,
                          odom_err_integ_ang=integ_ang)


def measure(state: PFState, likelihood) -> PFState:
    """`ParticleFilter::measure` (`pf.h:247-269`): posterior ∝ prior ×
    likelihood (B, N); a robot whose whole cloud dies keeps its prior."""
    raw = state.prob * likelihood
    s = raw.sum(dim=1, keepdim=True)
    prob = torch.where(s > 0.0, raw / torch.clamp(s, min=1e-30), state.prob)
    return state._replace(prob=prob)


def _normal_likelihood(x, sigma: float):
    """mcl_3dl::NormalLikelihood (nd.h), a = 1/sqrt(2π σ²): an f32
    constant worked out in numpy (the square root correctly rounded, as
    ``jnp.sqrt``'s), so the update reads no tensor back to the host."""
    a = recip(float(np.sqrt(np.float32(2.0 * math.pi * sigma * sigma))))
    return a * exp_fma(-x * x * recip(2.0 * sigma * sigma))


def bias_weights(state: PFState, prev_pos, prev_quat, cfg: MCLConfig,
                 uniform: bool = False):
    """`MCL3dlNode::measure`'s bias (`mcl_3dl.cpp:508-531`): particles far
    from the previous expectation (B, 3)/(B, 4) are down-weighted; uniform
    during global localization. Returns (B, N)."""
    if uniform:
        return torch.ones_like(state.prob)
    lin_diff = fma_norm(state.pos - prev_pos[:, None, :])
    qrel = quat_multiply_fma(state.quat, quat_conjugate(prev_quat)[:, None, :])
    ang_diff = 2.0 * torch.acos(torch.clamp(torch.abs(qrel[..., 3]), 0.0, 1.0))
    return (_normal_likelihood(lin_diff, cfg.bias_var_dist)
            * _normal_likelihood(ang_diff, cfg.bias_var_ang) + 1e-6)


def _weighted_mean_pose(pos, quat, w):
    """Weighted mean position; the quaternion mean as the sign-aligned
    weighted component sum, normalized (ParticleWeightedMean)."""
    wsum = torch.clamp(w.sum(dim=1), min=1e-30)
    mean_pos = (pos * w[..., None]).sum(dim=1) / wsum[:, None]
    ref = quat.gather(1, torch.argmax(w, dim=1)[:, None, None].expand(
        -1, 1, 4))                                                # (B,1,4)
    sign = torch.where((quat * ref).sum(dim=-1) < 0.0, -1.0, 1.0)
    mean_quat = quat_normalize((quat * (w * sign)[..., None]).sum(dim=1))
    return mean_pos, mean_quat


def expectation(state: PFState):
    return _weighted_mean_pose(state.pos, state.quat, state.prob)


def expectation_biased(state: PFState, bias):
    """`pf.h:283-291`."""
    return _weighted_mean_pose(state.pos, state.quat, state.prob * bias)


def max_particle(state: PFState):
    """Each robot's most probable particle: ((B, 3), (B, 4))."""
    i = torch.argmax(state.prob, dim=1)
    return _take(state.pos, i[:, None])[:, 0], _take(state.quat, i[:, None])[:, 0]


def _take(x, idx):
    """x[b, idx[b, i]] for (B, N, ...) x and (B, N) idx."""
    return x.gather(1, idx.view(*idx.shape, *(1,) * (x.dim() - 2)).expand(
        *idx.shape, *x.shape[2:]))


def resample(state: PFState, cfg: MCLConfig, u, pos_n, rpy_n) -> PFState:
    """Systematic resampling with duplicate-only noise (`pf.h:177-219`):
    pscan_i = pstep·i + u·pstep, the source of draw i is the first
    cumulative weight ≥ pscan_i; the first draw of a source copies it
    exactly, later draws of the same source add ``resample_var_*`` noise.
    ``u`` (B,) unit uniforms, ``pos_n``/``rpy_n`` (B, N, 3) unit normals."""
    n = state.prob.shape[1]
    accum = cumsum_xla(state.prob).contiguous()                   # (B, N)
    pstep = accum[:, -1] * recip(n)
    u0 = torch.clamp(u * pstep, min=0.0)
    j = torch.arange(n, dtype=torch.float32, device=u.device)
    pscan = fma(pstep[:, None], j, u0[:, None])
    idx = torch.searchsorted(accum, pscan, side="left")
    overflow = idx >= n          # it == end(): keep the previous state
    idx = torch.clamp(idx, 0, n - 1)
    dup = torch.cat([torch.zeros_like(idx[:, :1], dtype=torch.bool),
                     idx[:, 1:] == idx[:, :-1]], dim=1) & ~overflow
    dp, dq = _pose_noise(pos_n, rpy_n, _sigma(cfg, "resample_var"))
    pos, quat = _take(state.pos, idx), _take(state.quat, idx)
    pos = torch.where(dup[..., None], pos + dp, pos)
    quat = torch.where(dup[..., None],
                       quat_normalize(quat_multiply_fma(dq, quat)), quat)
    return _gather_particles(state, idx, torch.full_like(
        state.prob, 1.0 / n))._replace(pos=pos, quat=quat)


def _gather_particles(state: PFState, idx, prob) -> PFState:
    return PFState(
        pos=_take(state.pos, idx), quat=_take(state.quat, idx), prob=prob,
        odom_err_integ_lin=_take(state.odom_err_integ_lin, idx),
        odom_err_integ_ang=_take(state.odom_err_integ_ang, idx),
        noise_ll=_take(state.noise_ll, idx), noise_la=_take(state.noise_la, idx),
        noise_aa=_take(state.noise_aa, idx), noise_al=_take(state.noise_al, idx))


def resize_particles(state: PFState, m: int) -> PFState:
    """`ParticleFilter::resizeParticle` (`pf.h:387-430`): deterministic
    systematic resampling of every robot's cloud to ``m`` particles
    (pscan = pstep·(i + 1) over the cumulative weights, no noise), the
    global-localization shrink (`mcl_3dl.cpp:661-676`)."""
    n = state.prob.shape[1]
    accum = cumsum_xla(state.prob).contiguous()
    pstep = accum[:, -1] * recip(m)
    pscan = pstep[:, None] * (torch.arange(m, dtype=torch.float32,
                                           device=accum.device) + 1.0)
    idx = torch.clamp(torch.searchsorted(accum, pscan, side="left"), 0, n - 1)
    return _gather_particles(state, idx, torch.full(
        (state.prob.shape[0], m), 1.0 / m, device=accum.device))


def seed_particles_at(positions, yaws) -> PFState:
    """One particle per candidate pose: positions (B, N, 3), yaws (B, N)
    (the global-localization spread over ground nodes × a yaw grid)."""
    b, n = yaws.shape
    z3 = torch.zeros((b, n, 3), device=yaws.device)
    z1 = torch.zeros((b, n), device=yaws.device)
    return PFState(pos=positions, quat=quat_from_yaw(yaws),
                   prob=torch.full((b, n), 1.0 / n, device=yaws.device),
                   odom_err_integ_lin=z3, odom_err_integ_ang=z3,
                   noise_ll=z1, noise_la=z1, noise_aa=z1, noise_al=z1)


def add_pose_noise(state: PFState, sigma6, pos_n, rpy_n) -> PFState:
    """`ParticleFilter::noise`, the expansion resetting
    (`mcl_3dl.cpp:648-659`), from (B, N, 3) unit normals."""
    dp, dq = _pose_noise(pos_n, rpy_n, sigma6)
    return state._replace(pos=state.pos + dp,
                          quat=quat_normalize(quat_multiply_fma(dq, state.quat)))


def refresh_odom_noise(state: PFState, cfg: MCLConfig, normals) -> PFState:
    """The per-particle odometry noise coefficients
    (`mcl_3dl.cpp:222-231`) from (B, N, 4) unit normals."""
    return state._replace(
        noise_ll=normals[..., 0] * cfg.odom_err_lin_lin,
        noise_la=normals[..., 1] * cfg.odom_err_lin_ang,
        noise_aa=normals[..., 2] * cfg.odom_err_ang_ang,
        noise_al=normals[..., 3] * cfg.odom_err_ang_lin)


def reset_err_integrals(state: PFState) -> PFState:
    """The integral reset on a detected jump (`mcl_3dl.cpp:568-575`)."""
    z = torch.zeros_like(state.odom_err_integ_lin)
    return state._replace(odom_err_integ_lin=z, odom_err_integ_ang=z)


def covariance(state: PFState):
    """(B, 6, 6) pose covariance over (x, y, z, roll, pitch, yaw)
    (`mcl_3dl.cpp:597-618`)."""
    mean_pos, mean_quat = expectation(state)
    rpy = torch.stack(rpy_from_quat(state.quat), dim=-1)
    mean_rpy = torch.stack(rpy_from_quat(mean_quat), dim=-1)
    drpy = (torch.remainder(rpy - mean_rpy[:, None, :] + math.pi,
                            2.0 * math.pi) - math.pi)
    d = torch.cat([state.pos - mean_pos[:, None, :], drpy], dim=-1)
    w = state.prob / torch.clamp(state.prob.sum(dim=1, keepdim=True),
                                 min=1e-30)
    return torch.einsum("bni,bnj->bij", d * w[..., None], d)
