"""f32 arithmetic rounded as XLA compiles the JAX package's jitted tick on
the CPU, where eager PyTorch would round otherwise.

The port is held to the JAX package bit for bit where a compare at a
threshold follows (a voxel key, the inflation gate, a warm relaxation's
fixpoint), and XLA on the CPU does not round as eager PyTorch does:

* a division by a constant is a multiply by the constant's f32 reciprocal
  (:func:`recip`);
* a reduce of a product — ``jnp.sum(a * b, -1)``, ``jnp.linalg.norm``, a
  small f32 ``jnp.dot`` at Precision.HIGHEST — is a chain of fused
  multiply-adds (:func:`fma_dot`);
* ``jnp.exp`` is the Cephes polynomial with fused multiply-adds, flushing
  subnormal results to zero (:func:`exp_fma`);
* ``jnp.sqrt`` is correctly rounded, where PyTorch's vectorised f32 sqrt
  on the CPU may miss by an ulp (:func:`sqrt_rn`);
* ``jnp.cumsum`` is a blocked scan: sequential f32 sums within blocks of
  16, plus the scan of the block totals (:func:`cumsum_xla`), where
  ``torch.cumsum`` accumulates otherwise on each device.

A fused multiply-add runs in f64, where the product of two f32 values is
exact, and rounds once to f32; the GPU and the CPU give the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

_F32_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def f32(c: float) -> float:
    """The f32 value of the constant ``c``, as a Python float."""
    return float(np.float32(c))


def recip(c: float) -> float:
    """The f32 reciprocal of the f32 constant ``c``, as a Python float."""
    return float(np.float32(1.0) / np.float32(c))


def fma(a, b, c):
    """a·b + c rounded once to f32; tensors or Python floats that are f32
    values, at least one a tensor."""
    a = a.double() if torch.is_tensor(a) else a
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    return (a * b + c).float()


def fma_dot(a, b):
    """Σ a·b over the last axis as acc = fma(a[i], b[i], acc); ``a`` and
    ``b`` broadcast against each other."""
    acc = (a[..., 0].double() * b[..., 0].double()).float()
    for i in range(1, a.shape[-1]):
        acc = fma(a[..., i], b[..., i], acc)
    return acc


def sqrt_rn(x):
    """The correctly rounded f32 square root, through f64."""
    return torch.sqrt(x.double()).float()


def fma_norm(v):
    """:func:`sqrt_rn` of :func:`fma_dot`(v, v): ``jnp.linalg.norm`` over
    the last axis."""
    return sqrt_rn(fma_dot(v, v))


_SCAN_BLOCK = 16


def cumsum_xla(x):
    """Inclusive f32 cumsum over the last axis in XLA's order on the CPU:
    the axis is zero-padded to blocks of 16 and summed left to right within
    each block; each block then adds the (recursively scanned) sum of the
    blocks before it. Resampling searches these sums, so an ulp moves a
    particle's source index at a boundary."""
    n = x.shape[-1]
    nb = -(-n // _SCAN_BLOCK)
    xp = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n))
    xp = xp.reshape(*x.shape[:-1], nb, _SCAN_BLOCK)
    cols = [xp[..., 0]]
    for j in range(1, _SCAN_BLOCK):
        cols.append(cols[-1] + xp[..., j])
    c = torch.stack(cols, dim=-1)                       # (..., nb, 16)
    if nb > 1:
        before = cumsum_xla(c[..., -1])[..., :-1]
        c = torch.cat([c[..., :1, :], c[..., 1:, :] + before[..., None]],
                      dim=-2)
    return c.reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :n]


# Cephes expf: log2(e), ln 2 in two parts, the polynomial of exp(r).
_LOG2E = f32(1.44269504088896341)
_LN2_HI, _LN2_LO = f32(0.693359375), f32(-2.12194440e-4)
_EXP_P = [f32(c) for c in (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
                           4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)]


def exp_fma(x):
    """f32 exp(x) as XLA on the CPU computes it (x f32)."""
    x = torch.clamp(x, f32(-88.3762626647949), f32(88.3762626647950))
    k = torch.floor(fma(x, _LOG2E, 0.5))
    r = fma(k, -_LN2_HI, x)
    r = fma(k, -_LN2_LO, r)
    y = torch.full_like(r, _EXP_P[0])
    for c in _EXP_P[1:]:
        y = fma(y, r, c)
    y = fma(y, r * r, r) + 1.0
    pow2 = ((k.int() + 127) << 23).view(torch.float32)
    out = y * pow2
    return torch.where(out < _F32_MIN_NORMAL, 0.0, out)
