"""The MCL update of a fleet of robots, one call for every robot's filter.

Counterpart of ``dddmr_navigation_tpu/state_estimation/mcl.py``
(``MCL3dlNode``, `mcl_3dl.cpp:143-680`): predict → measure → bias →
expectation → jump detection → LPF map→odom → expansion reset → resample →
odometry-noise refresh, every step a tensor op over the robot axis B with
no host read. The state carries no random key: each update takes its
draws (:class:`pf.MCLDraws`, from :func:`pf.draw_mcl` or replayed).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from navbench.reference.config import MCLConfig
from navbench.reference.geometry import (
    quat_conjugate, quat_from_rpy, quat_multiply_fma, quat_normalize,
    quat_rotate_fma, rpy_from_quat)
from navbench.reference.rounding import fma_norm
from navbench.reference.state_estimation import pf as pflib
from navbench.reference.state_estimation.likelihood import (
    SubmapContext, measure_all, measure_all_corr)


class Lpf3(NamedTuple):
    """Three time-domain LPFs (`filter.h:54-98`, time constant
    ``lpf_step``), state (x, out), each (B, 3)."""
    x: torch.Tensor
    out: torch.Tensor


def _lpf_coeffs(tc: float):
    k3 = -1.0 / (1.0 + 2.0 * tc)
    k2 = -k3
    k1 = (1.0 - 2.0 * tc) * k3
    k0 = -k1 - 1.0
    return k0, k1, k2, k3


def lpf_set(tc: float, out0) -> Lpf3:
    _, _, k2, k3 = _lpf_coeffs(tc)
    return Lpf3(x=(1.0 - k2) * out0 / k3, out=out0)


def lpf_in(tc: float, f: Lpf3, v, angle: bool = False):
    k0, k1, k2, k3 = _lpf_coeffs(tc)
    if angle:
        v = f.out + torch.remainder(v - f.out + math.pi, 2.0 * math.pi) \
            - math.pi
    x = k0 * v + k1 * f.x
    out = k2 * v + k3 * x
    return Lpf3(x=x, out=out), out


class MCLState(NamedTuple):
    """Every robot's localization state."""
    particles: pflib.PFState
    state_prev_pos: torch.Tensor   # (B, 3) previous expectation
    state_prev_quat: torch.Tensor  # (B, 4)
    f_pos: Lpf3                    # map→odom translation LPF
    f_ang: Lpf3                    # map→odom rpy LPF


class MCLOutput(NamedTuple):
    pose_pos: torch.Tensor         # (B, 3) expectation (mcl_pose)
    pose_quat: torch.Tensor        # (B, 4)
    map2odom_pos: torch.Tensor     # (B, 3) LPF'd map→odom
    map2odom_quat: torch.Tensor    # (B, 4)
    covariance: torch.Tensor       # (B, 6, 6)
    match_ratio_max: torch.Tensor  # (B,)
    jumped: torch.Tensor           # (B,) bool
    expanded: torch.Tensor         # (B,) bool


def _stack_rpy(q):
    return torch.stack(rpy_from_quat(q), dim=-1)


def init_mcl(cfg: MCLConfig, init_pos, init_quat, pos_n, rpy_n) -> MCLState:
    """Filters at the poses (B, 3)/(B, 4), particles from (B, N, 3) unit
    normals (N = ``cfg.num_particles`` when drawn by :func:`init_draws`)."""
    return MCLState(
        particles=pflib.init_particles(cfg, init_pos, init_quat, pos_n,
                                       rpy_n),
        state_prev_pos=init_pos, state_prev_quat=init_quat,
        f_pos=lpf_set(cfg.lpf_step, init_pos),
        f_ang=lpf_set(cfg.lpf_step, _stack_rpy(init_quat)))


def init_draws(generator: torch.Generator, cfg: MCLConfig, b: int, device):
    """The (B, N, 3) unit normals :func:`init_mcl` spreads particles with."""
    n = cfg.num_particles
    return (torch.randn((b, n, 3), generator=generator, device=device),
            torch.randn((b, n, 3), generator=generator, device=device))


def relative_odom(odom_prev_pos, odom_prev_quat, odom_pos, odom_quat):
    """`MotionPredictionModelDifferentialDrive::setOdoms`: the translation
    in the previous odom frame, the relative rotation and its angle."""
    inv_prev = quat_conjugate(odom_prev_quat)
    rel_trans = quat_rotate_fma(inv_prev, odom_pos - odom_prev_pos)
    rel_quat = quat_normalize(quat_multiply_fma(inv_prev, odom_quat))
    rel_angle = 2.0 * torch.acos(torch.clamp(torch.abs(rel_quat[..., 3]),
                                             0.0, 1.0))
    return rel_trans, rel_quat, rel_angle


def _where(cond, a, b):
    """Tuples of tensors selected per robot."""
    return type(a)(*(torch.where(cond.view(-1, *(1,) * (x.dim() - 1)), x, y)
                     for x, y in zip(a, b)))


def mcl_update(cfg: MCLConfig, ctx: SubmapContext, state: MCLState,
               odom_prev_pos, odom_prev_quat, odom_pos, odom_quat, dt,
               flat_pts, flat_mask, sharp_pts, sharp_mask, sharp_weight,
               draws: pflib.MCLDraws, global_mode: bool = False):
    """One update of every robot's filter (`cbOdom` + `measure`,
    `mcl_3dl.cpp:196-231,466-680`). Odometry (B, 3)/(B, 4) now and before,
    dt a () f32 tensor, feature clouds (B, F, 3)/(B, S, 3) with masks and
    the sharp points' weights (B, S). Returns (MCLState, MCLOutput)."""
    p = state.particles
    rel_trans, rel_quat, rel_angle = relative_odom(
        odom_prev_pos, odom_prev_quat, odom_pos, odom_quat)
    p = pflib.predict_diff_drive(p, rel_trans, rel_quat, rel_angle, dt, cfg)

    if cfg.field_sampling == "corr":
        pose0_pos = state.state_prev_pos + quat_rotate_fma(state.state_prev_quat,
                                                       rel_trans)
        pose0_quat = quat_normalize(quat_multiply_fma(state.state_prev_quat,
                                                  rel_quat))
        like, ratio = measure_all_corr(
            ctx, cfg, flat_pts, flat_mask, sharp_pts, sharp_mask,
            sharp_weight, p.pos, p.quat, pose0_pos, pose0_quat)
    else:
        like, ratio = measure_all(ctx, cfg, flat_pts, flat_mask, sharp_pts,
                                  sharp_mask, sharp_weight, p.pos, p.quat)
    p = pflib.measure(p, like)
    match_ratio_max = ratio.amax(dim=1)

    bias = pflib.bias_weights(p, state.state_prev_pos, state.state_prev_quat,
                              cfg, uniform=global_mode)
    e_pos, e_quat = pflib.expectation_biased(p, bias)

    # map→odom (`mcl_3dl.cpp:548-551`)
    map_rot = quat_normalize(quat_multiply_fma(e_quat, quat_conjugate(odom_quat)))
    map_pos = e_pos - quat_rotate_fma(map_rot, odom_pos)

    # jump detection
    jump_dist = fma_norm(e_pos - state.state_prev_pos)
    qrel = quat_multiply_fma(quat_conjugate(e_quat), state.state_prev_quat)
    jump_ang = 2.0 * torch.acos(torch.clamp(torch.abs(qrel[..., 3]), 0.0, 1.0))
    jumped = (jump_dist > cfg.jump_dist) | (jump_ang > cfg.jump_ang)
    if global_mode:
        jumped = torch.ones_like(jumped)
    p = _where(jumped, pflib.reset_err_integrals(p), p)

    # LPF map→odom, reset on a jump (`mcl_3dl.cpp:585-590`)
    rpy = _stack_rpy(map_rot)
    f_pos = _where(jumped, lpf_set(cfg.lpf_step, map_pos), state.f_pos)
    f_ang = _where(jumped, lpf_set(cfg.lpf_step, rpy), state.f_ang)
    f_ang, rpy_f = lpf_in(cfg.lpf_step, f_ang, rpy, angle=True)
    f_pos, pos_f = lpf_in(cfg.lpf_step, f_pos, map_pos)
    map_rot_f = quat_from_rpy(rpy_f[..., 0], rpy_f[..., 1], rpy_f[..., 2])

    cov = pflib.covariance(p)

    # expansion resetting (`mcl_3dl.cpp:648-659`)
    expanded = match_ratio_max < cfg.match_ratio_thresh
    p = _where(expanded, pflib.add_pose_noise(
        p, pflib._sigma(cfg, "expansion_var"), draws.expand_pos,
        draws.expand_rpy), p)

    # resample, then refresh the odometry noise (`mcl_3dl.cpp:212-231`)
    p = pflib.resample(p, cfg, draws.resample_u, draws.resample_pos,
                       draws.resample_rpy)
    p = pflib.refresh_odom_noise(p, cfg, draws.odom)

    new_state = MCLState(particles=p, state_prev_pos=e_pos,
                         state_prev_quat=e_quat, f_pos=f_pos, f_ang=f_ang)
    out = MCLOutput(pose_pos=e_pos, pose_quat=e_quat, map2odom_pos=pos_f,
                    map2odom_quat=map_rot_f, covariance=cov,
                    match_ratio_max=match_ratio_max, jumped=jumped,
                    expanded=expanded)
    return new_state, out


def motion_gate(cfg: MCLConfig, odom_prev_pos, odom_prev_quat, odom_pos,
                odom_quat):
    """The update gate (`mcl_3dl.cpp:196`): translation over
    ``update_min_d`` or an rpy change over ``update_min_a``. Returns (B,)."""
    d = fma_norm(odom_pos - odom_prev_pos)
    a = fma_norm(_stack_rpy(odom_quat) - _stack_rpy(odom_prev_quat))
    return (d > cfg.update_min_d) | (a > cfg.update_min_a)
