"""f32 arithmetic rounded as XLA compiles the JAX package's jitted tick on
the CPU, where eager PyTorch would round otherwise.

The port is held to the JAX package bit for bit where a compare at a
threshold follows (a voxel key, the inflation gate, a warm relaxation's
fixpoint), and XLA on the CPU does not round as eager PyTorch does:

* a division by a constant is a multiply by the constant's f32 reciprocal
  (:func:`recip`), and a further constant factor folds into it
  (:func:`recip_times`);
* a reduce of a product — ``jnp.sum(a * b, -1)``, ``jnp.linalg.norm``, a
  small f32 ``jnp.dot`` at Precision.HIGHEST — is a chain of fused
  multiply-adds (:func:`fma_dot`);
* ``jnp.exp`` is the Cephes polynomial with fused multiply-adds, flushing
  subnormal results to zero (:func:`exp_fma`);
* ``jnp.sqrt`` is correctly rounded, where PyTorch's vectorised f32 sqrt
  on the CPU may miss by an ulp (:func:`sqrt_rn`);
* ``jnp.sum`` over a long axis is a tree: windows of 32 summed in order,
  then windows of 32 of those, until 32 or fewer remain, which are summed
  in order (:func:`sum_rows_xla`); ``jnp.mean`` multiplies that by the
  reciprocal of the count;
* ``jnp.cumsum`` is a blocked scan: sequential f32 sums within blocks of
  16, plus the scan of the block totals (:func:`cumsum_xla`), where
  ``torch.cumsum`` accumulates otherwise on each device;
* ``jnp.arctan2`` is the C library's ``atan2f`` (fdlibm's algorithm),
  ``jnp.arccos(x)`` is ``atan2f(sqrt((1 - x)·(1 + x)), x)`` and
  ``jnp.arcsin(x)`` is ``2·atan2f(x, 1 + sqrt((1 - x)·(1 + x)))``
  (:func:`atan2_xla`, :func:`acos_xla`, :func:`asin_xla`), where PyTorch's
  vectorised versions differ in the last ulp for about one value in six:
  the planner's turning table breaks ties between equal-cost paths, and a
  scan point's range-image bin moves, on those ulps.

A fused multiply-add runs in f64, where the product of two f32 values is
exact, and rounds once to f32; the GPU and the CPU give the same bits.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_F32_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def f32(c: float) -> float:
    """The f32 value of the constant ``c``, as a Python float."""
    return float(np.float32(c))


def recip(c: float) -> float:
    """The f32 reciprocal of the f32 constant ``c``, as a Python float."""
    return float(np.float32(1.0) / np.float32(c))


def recip_times(c: float, n: float) -> float:
    """The one f32 constant XLA folds ``x / c * n`` into: ``x`` times
    recip(c)·n rounded to f32 (it turns the division into a multiply and
    then folds the constant factors together)."""
    return float(np.float32(recip(c)) * np.float32(n))


def fma(a, b, c):
    """a·b + c rounded once to f32; tensors or Python floats that are f32
    values, at least one a tensor."""
    a = a.double() if torch.is_tensor(a) else a
    b = b.double() if torch.is_tensor(b) else b
    c = c.double() if torch.is_tensor(c) else c
    if torch.is_tensor(a) and torch.is_tensor(b) and torch.is_tensor(c):
        return torch.addcmul(c, a, b).float()     # one kernel for a·b + c
    return (a * b + c).float()


def fma_dot(a, b):
    """Σ a·b over the last axis as acc = fma(a[i], b[i], acc); ``a`` and
    ``b`` broadcast against each other."""
    ad, bd = a.double(), b.double()
    acc = (ad[..., 0] * bd[..., 0]).float()
    for i in range(1, a.shape[-1]):
        acc = torch.addcmul(acc.double(), ad[..., i], bd[..., i]).float()
    return acc


def sqrt_rn(x):
    """The correctly rounded f32 square root, through f64."""
    return torch.sqrt(x.double()).float()


def fma_norm(v):
    """:func:`sqrt_rn` of :func:`fma_dot`(v, v): ``jnp.linalg.norm`` over
    the last axis."""
    return sqrt_rn(fma_dot(v, v))


_SCAN_BLOCK = 16
_REDUCE_WINDOW = 32


def _sum_in_order(x):
    """Σ over axis 0, left to right, in f32."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def sum_rows_xla(x):
    """f32 sum over axis 0 as XLA on the CPU reduces it: an axis longer
    than 32 is zero-padded to whole windows of 32 (the padding split
    between its two ends, the smaller half first) and each window summed
    in order; the window sums are reduced the same way, and the last 32 or
    fewer are summed in order. The submap's target mean reads it: matched
    against a 1e6-padded submap, the squared distances cancel down to the
    rounding of that mean."""
    while x.shape[0] > _REDUCE_WINDOW:
        n = -(-x.shape[0] // _REDUCE_WINDOW)
        pad = n * _REDUCE_WINDOW - x.shape[0]
        low = torch.zeros((pad // 2,) + x.shape[1:], dtype=x.dtype,
                          device=x.device)
        high = torch.zeros((pad - pad // 2,) + x.shape[1:], dtype=x.dtype,
                           device=x.device)
        x = torch.cat([low, x, high]).reshape(
            (n, _REDUCE_WINDOW) + x.shape[1:]).transpose(0, 1)
        x = _sum_in_order(x)
    return _sum_in_order(x)


def mean_rows_xla(x):
    """``jnp.mean`` over axis 0 (:func:`sum_rows_xla` times the f32
    reciprocal of the count)."""
    return sum_rows_xla(x) * recip(x.shape[0])


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


# The C library's atanf (fdlibm's, float): its reduction breakpoints,
# atan at them in two parts, and the odd and even polynomial coefficients.
_ATAN_HI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
            1.5707962513e+00)
_ATAN_LO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
            7.5497894159e-08)
_AT = [f32(c) for c in (
    3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01, -1.1111110449e-01,
    9.0908870101e-02, -7.6918758452e-02, 6.6610731184e-02, -5.8335702866e-02,
    4.9768779427e-02, -3.6531571299e-02, 1.6285819933e-02)]
_PI, _PI_LO, _PI_2 = f32(3.1415927410e+00), f32(-8.7422776573e-08), \
    f32(1.5707963705e+00)


@functools.lru_cache(maxsize=None)
def _atan_tables(device):
    """The reduction's breakpoints and, per part (none, then 0-3), the
    coefficients of r = (p·|x| - q) / (s + t·|x|) and atan at the
    breakpoint in two parts, as tensors on ``device`` (copied there once:
    a copy per call would be a host sync)."""
    def t(values):
        return torch.tensor(values, dtype=torch.float32, device=device)
    return (t([0.4375, 0.6875, 1.1875, 2.4375]),
            t([0.0, 2.0, 1.0, 1.0, 0.0]), t([0.0, 1.0, 1.0, 1.5, 1.0]),
            t([1.0, 2.0, 1.0, 1.0, 0.0]), t([0.0, 1.0, 1.0, 1.5, 1.0]),
            t((0.0,) + _ATAN_HI), t((0.0,) + _ATAN_LO))


def _atanf(x):
    """fdlibm's float atan, op for op in f32 (``x`` finite). Its four
    reductions (2|x| - 1)/(2 + |x|), (|x| - 1)/(|x| + 1),
    (|x| - 1.5)/(1 + 1.5|x|) and -1/|x| are one formula with per-part
    coefficients, each product and sum rounding as fdlibm's do."""
    bounds, cp, cq, cs, ct, hi, lo = _atan_tables(x.device)
    ax = torch.abs(x)
    part = torch.bucketize(ax, bounds, right=True)     # 0: |x| < 0.4375
    r = torch.where(part == 0, x,
                    (cp[part] * ax - cq[part]) / (cs[part] + ct[part] * ax))
    z = r * r
    w = z * z
    s1 = _AT[10]
    for c in (_AT[8], _AT[6], _AT[4], _AT[2], _AT[0]):
        s1 = c + w * s1
    s2 = _AT[9]
    for c in (_AT[7], _AT[5], _AT[3], _AT[1]):
        s2 = c + w * s2
    sr = r * (z * s1 + w * s2)
    big = hi[part] - ((sr - lo[part]) - r)
    out = torch.where(part == 0, r - sr, torch.where(x < 0, -big, big))
    inf = f32(f32(_ATAN_HI[3]) + f32(_ATAN_LO[3]))
    return torch.where(ax >= 2.0 ** 25, torch.where(x > 0, inf, -inf), out)


def atan2_xla(y, x):
    """f32 atan2 as XLA computes it on the CPU, which calls the C
    library's ``atan2f`` (fdlibm's algorithm in glibc), reproduced op for
    op in PyTorch so that it gives the same bits on every device (finite
    inputs)."""
    y, x = torch.broadcast_tensors(y, x)
    z = _atanf(torch.abs(y / x))
    sy, sx = torch.signbit(y), torch.signbit(x)
    out = torch.where(sx, torch.where(sy, (z - _PI_LO) - _PI,
                                      _PI - (z - _PI_LO)),
                      torch.where(sy, -z, z))
    out = torch.where(y == 0, torch.where(sx, torch.where(sy, -_PI, _PI), y),
                      out)
    out = torch.where((x == 0) & (y != 0), torch.where(y < 0, -_PI_2, _PI_2),
                      out)
    return torch.where(x == 1.0, _atanf(y), out)


def acos_xla(x):
    """f32 arccos as XLA lowers it on the CPU:
    atan2(sqrt((1 - x)·(1 + x)), x), with :func:`atan2_xla`."""
    return atan2_xla(sqrt_rn((1.0 - x) * (1.0 + x)), x)


def asin_xla(x):
    """f32 arcsin as XLA lowers it on the CPU:
    2·atan2(x, 1 + sqrt((1 - x)·(1 + x))), with :func:`atan2_xla`."""
    a = atan2_xla(x, 1.0 + sqrt_rn((1.0 - x) * (1.0 + x)))
    return a + a
