"""Semantic segmentation → class-labelled point clouds (counterpart of
``dddmr_navigation_tpu/perception/semantic.py``, the re-design of
``dddmr_semantic_segmentation``).

The reference runs a DDRNet23-slim TensorRT engine
(`scripts/trt_interface.py:16-80`) and a C++ node that fuses the class mask
with a depth image into per-class point clouds
(`src/semantic_segmentation2point_cloud.cpp:81-176`, intensity = class id).
Here, as in the JAX package:

* :class:`DDRNetSlim` — a dual-resolution net: a detail branch at 1/8, a
  context branch to 1/32, one bilateral fusion, logits upsampled to 1/2.
  Activations are bf16, the logits f32, as flax computes them. Its
  submodules are named as flax names them (``ConvBN_0`` … ``ConvBN_8``,
  ``Conv_0``; each ``ConvBN`` holds ``Conv_0`` and ``GroupNorm_0``), so the
  JAX package's weights map by name (:func:`flax_key`).
* :func:`infer_classes` — RGB (B, H, W, 3) → (B, H, W) class ids.
* :func:`segmentation_to_pointcloud` — depth + class mask → xyz+class cloud.
* :func:`softmax_ce_loss`, :func:`make_train_step` — the train step
  (autograd, Adam with optax's defaults).

The interface keeps JAX's NHWC images; inside, tensors are NCHW (and
channels-last in memory on the card, where cuDNN runs the bf16
convolutions on tensor cores).

Rounding, where it decides a class: each op rounds as the JAX package's
jitted program rounds on the CPU.

* A convolution of ``dtype`` bf16 (``nn.Conv(..., dtype=bfloat16)``) is a
  convolution in f32 of bf16-rounded inputs and weights. XLA (with its
  default excess precision) hands the f32 sums to the GroupNorm that
  follows unrounded: the statistics read them rounded to bf16, the
  normalization unrounded. Its ``SAME`` padding is flax's: a stride-2
  window on an even size pads (0, 1), not (1, 1) (:func:`same_pads`).
* GroupNorm (:class:`GroupNorm`) is flax's formula: f32 statistics by
  E[x²] − E[x]² clipped at 0, the means as sums times the f32 reciprocal
  of the count, ``rsqrt`` correctly rounded, then
  ``(x − mean)·(rsqrt(var + eps)·scale) + bias`` as one fused multiply-add,
  rounded to bf16. XLA on the CPU sums each group in windows of 32 along
  every reduced axis longer than 32 (:func:`group_sums`); the port sums in
  that order on the CPU and in f64 on the card. Where LLVM vectorizes an
  unwindowed group sum the orders part: a statistic an ulp off moves
  an output by one bf16 ulp.
* ``jax.image.resize(..., "bilinear")`` (:func:`resize_bilinear`) is two
  contractions with per-axis weight matrices (half-pixel centres, a
  triangle kernel, the columns renormalized), each matrix cast to the
  activation's dtype: the width first, then the height, the intermediate
  rounded to that dtype. XLA's CPU dots add a tap's product in one
  fused multiply-add, except the height contraction of the last f32
  upsample (``fused_h=False``), which rounds each product first.
* The f32 logits convolution runs with TF32 off on the card
  (:func:`ieee_f32`); the resizes gather and multiply elementwise, with no
  product TF32 could take.

The train step has no kernel of its own to port: JAX's is XLA autodiff, the
port's PyTorch autograd over the same forward.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dddmr_navigation_tpu_torch.perception.depth_camera import (
    depth_image_to_points)
from dddmr_navigation_tpu_torch.rounding import fma, recip

GN_GROUPS = 8
GN_EPS = 1e-6
_REDUCE_WINDOW = 32       # XLA's CPU tree reduction: windows of 32


@contextlib.contextmanager
def ieee_f32(device):
    """f32 matrix products and convolutions in full f32 on the card (TF32
    off) inside the block, restored after it; nothing on the CPU."""
    if torch.device(device).type != "cuda":
        yield
        return
    conv, mm = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def same_pads(size: int, kernel: int, stride: int) -> tuple:
    """flax's ``SAME`` padding of one spatial axis (``lax.padtype_to_pads``):
    the output keeps ceil(size / stride) cells and the padding's odd cell
    goes to the high end — (0, 1) for a stride-2 3-window on an even
    size, (1, 1) on an odd one."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax's ``nn.Conv`` with ``SAME`` padding on NCHW tensors: weight
    (O, I, kh, kw) f32 and an optional bias, computed in ``dtype``. A bf16
    convolution returns its f32 sums unrounded: XLA keeps them so for the
    GroupNorm that follows (:class:`GroupNorm`)."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel, self.stride, self.dtype = kernel, stride, dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if bias else None

    def forward(self, x):
        ph = same_pads(x.shape[-2], self.kernel, self.stride)
        pw = same_pads(x.shape[-1], self.kernel, self.stride)
        if any(ph + pw):
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        if self.dtype == torch.bfloat16:
            # bf16 values are exact in TF32, so the card may run this one on
            # TF32 tensor cores: exact products, f32 accumulation.
            return F.conv2d(x.bfloat16().float(),
                            self.weight.bfloat16().float(), stride=self.stride)
        with ieee_f32(x.device):
            y = F.conv2d(x.float(), self.weight.float(), stride=self.stride)
        if self.bias is not None:      # added after the product, as XLA does
            y = y + self.bias[:, None, None]
        return y


def _xla_sum(a: np.ndarray) -> np.ndarray:
    """f32 sums over the trailing axes of ``a`` (leading axis kept) in XLA's
    CPU order: every reduced axis longer than 32 is zero-padded to whole
    windows of 32 (the padding split between its ends) and each window is
    summed in row-major order; the window sums are reduced the same way,
    and the last reduce runs in row-major order."""
    lead, red = a.shape[:1], list(a.shape[1:])
    while any(s > _REDUCE_WINDOW for s in red):
        pads, counts, widths = [(0, 0)], [], []
        for s in red:
            if s > _REDUCE_WINDOW:
                n = -(-s // _REDUCE_WINDOW)
                p = n * _REDUCE_WINDOW - s
                pads.append((p // 2, p - p // 2))
                counts.append(n)
                widths.append(_REDUCE_WINDOW)
            else:
                pads.append((0, 0))
                counts.append(1)
                widths.append(s)
        a = np.pad(a, pads)
        split = [x for nw in zip(counts, widths) for x in nw]
        a = a.reshape(lead + tuple(split))
        r = len(red)
        a = a.transpose([0] + [1 + 2 * i for i in range(r)]
                        + [2 + 2 * i for i in range(r)])
        a = a.reshape(lead + tuple(counts) + (-1,))
        a = np.add.accumulate(a, axis=-1, dtype=np.float32)[..., -1]
        red = counts
    a = a.reshape(lead + (-1,))
    return np.add.accumulate(a, axis=-1, dtype=np.float32)[..., -1]


def group_sums(xg):
    """Σx and Σx² of each group: ``xg`` (B, G, gs, H, W) f32 → two (B, G)
    f32. On the CPU, with no gradient to carry, in XLA's CPU order over
    (H, W, gs); otherwise in f64, rounded once."""
    b, g = xg.shape[:2]
    if xg.is_cuda or (torch.is_grad_enabled() and xg.requires_grad):
        xd = xg.double()
        return (xd.sum(dim=(2, 3, 4)).float(),
                (xd * xd).sum(dim=(2, 3, 4)).float())
    a = xg.detach().permute(0, 1, 3, 4, 2).reshape(
        b * g, *xg.shape[3:], xg.shape[2]).numpy()
    s1 = _xla_sum(a)
    s2 = _xla_sum(a * a)
    return (torch.from_numpy(s1).view(b, g), torch.from_numpy(s2).view(b, g))


class GroupNorm(nn.Module):
    """flax's ``nn.GroupNorm(num_groups=8, dtype=bfloat16)`` (epsilon 1e-6)
    on NCHW: f32 statistics, scale and bias; the output rounded to bf16."""

    def __init__(self, features: int, groups: int = GN_GROUPS,
                 eps: float = GN_EPS):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, y):
        """``y``: a bf16 convolution's f32 sums (B, C, H, W). The statistics
        read them rounded to bf16 (the convolution's dtype) and the
        normalization reads them unrounded, as XLA compiles flax's module
        (its excess precision elides the round trip there)."""
        b, c, h, w = y.shape
        gs = c // self.groups
        xb = y.bfloat16().float()
        s1, s2 = group_sums(xb.view(b, self.groups, gs, h, w))
        r = recip(h * w * gs)
        mean, mean2 = s1 * r, s2 * r
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        inv = torch.rsqrt((var + self.eps).double()).float()
        mul = inv.repeat_interleave(gs, dim=1) * self.scale     # (B, C)
        d = y.float() - mean.repeat_interleave(gs, dim=1)[:, :, None, None]
        out = fma(d, mul[:, :, None, None], self.bias[:, None, None])
        return out.bfloat16()


class ConvBN(nn.Module):
    """Conv (bf16, no bias) → GroupNorm → ReLU."""

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 kernel: int = 3):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, kernel, stride)
        self.GroupNorm_0 = GroupNorm(features)

    def forward(self, x):
        return torch.relu(self.GroupNorm_0(self.Conv_0(x)))


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """``jax.image.resize``'s bilinear weight matrix (n_in, n_out), f32, as
    ``scale.py::compute_weight_mat`` builds it (no antialiasing needed:
    the port only upsamples)."""
    inv = np.float32(1.0) / (np.float32(n_out) / np.float32(n_in))
    s = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv
         - np.float32(0.5)).astype(np.float32)
    x = np.abs(s[None, :] - np.arange(n_in, dtype=np.float32)[:, None])
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x).astype(np.float32)
    tot = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(tot != 0, tot, np.float32(1.0)), 0.0)
    ok = (s >= -0.5) & (s <= n_in - 0.5)
    return np.where(ok[None, :], w, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _taps(n_in: int, n_out: int, bf16: bool, device: torch.device):
    """The nonzero taps of each output of :func:`resize_weights`, in
    ascending input order, on ``device``: indices (K, n_out) int64 and
    weights (K, n_out) f32 (rounded to bf16 first where the activation is
    bf16), K the most taps any output has (2 when upsampling); a short
    column repeats its last index with weight 0."""
    w = resize_weights(n_in, n_out)
    if bf16:
        w = torch.from_numpy(w).bfloat16().float().numpy()
    k = max(int((w != 0).sum(axis=0).max()), 1)
    idx = np.zeros((k, n_out), np.int64)
    wt = np.zeros((k, n_out), np.float32)
    for o in range(n_out):
        nz = np.nonzero(w[:, o])[0]
        if len(nz):
            idx[:len(nz), o] = nz
            idx[len(nz):, o] = nz[-1]
            wt[:len(nz), o] = w[nz, o]
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(wt).to(device))


def _contract(x, dim: int, n_out: int, fused: bool):
    """One axis of the resize: Σ_i w[i, o]·x[..., i, ...] over the nonzero
    taps in ascending order, the first product rounded and each later one
    added in a fused multiply-add (``fused``) or rounded before the add;
    in f32, rounded to ``x``'s dtype."""
    idx, wt = _taps(x.shape[dim], n_out, x.dtype == torch.bfloat16,
                    x.device)
    shape = [1] * x.dim()
    shape[dim] = n_out
    xf = x.float()
    acc = None
    for k in range(idx.shape[0]):
        xk = xf.index_select(dim, idx[k])
        w = wt[k].view(shape)
        if acc is None:
            acc = xk * w
        elif fused:
            acc = fma(xk, w, acc)
        else:
            acc = acc + xk * w
    return acc.to(x.dtype)


def resize_bilinear(x, height: int, width: int, fused_h: bool = True):
    """``jax.image.resize(x, (..., height, width, ...), "bilinear")`` for
    upsampling, on NCHW ``x`` (bf16 or f32): the width contraction, then the
    height one (:func:`_contract`); ``fused_h=False`` rounds the height
    contraction's products before their add."""
    if x.shape[-1] != width:
        x = _contract(x, x.dim() - 1, width, True)
    if x.shape[-2] != height:
        x = _contract(x, x.dim() - 2, height, fused_h)
    return x


class DDRNetSlim(nn.Module):
    """Dual-resolution segmentation net (DDRNet23-slim shape class): detail
    branch at 1/8, context branch to 1/32, one bilateral fusion, logits at
    1/2. ``forward`` takes RGB (B, H, W, 3) f32 and returns f32 logits
    (B, H/2, W/2, C), as flax's ``model.apply``."""

    def __init__(self, num_classes: int = 19, width: int = 32):
        super().__init__()
        w = width
        self.num_classes, self.width = num_classes, width
        self.ConvBN_0 = ConvBN(3, w, stride=2)          # stem: 1/4
        self.ConvBN_1 = ConvBN(w, w, stride=2)
        self.ConvBN_2 = ConvBN(w, 2 * w, stride=2)      # shared stage: 1/8
        self.ConvBN_3 = ConvBN(2 * w, 2 * w)            # detail stays 1/8
        self.ConvBN_4 = ConvBN(2 * w, 4 * w, stride=2)  # context: 1/16
        self.ConvBN_5 = ConvBN(4 * w, 4 * w)
        self.ConvBN_6 = ConvBN(4 * w, 8 * w, stride=2)  # 1/32
        self.ConvBN_7 = ConvBN(8 * w, 2 * w, kernel=1)
        self.ConvBN_8 = ConvBN(2 * w, 2 * w)
        self.Conv_0 = Conv(2 * w, num_classes, kernel=1, bias=True,
                           dtype=torch.float32)

    def logits_nchw(self, rgb):
        """RGB (B, H, W, 3) → logits (B, C, H/2, W/2) f32."""
        x = rgb.permute(0, 3, 1, 2).bfloat16()
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        x = self.ConvBN_0(x)
        x = self.ConvBN_1(x)
        x = self.ConvBN_2(x)
        detail = self.ConvBN_3(x)
        ctx = self.ConvBN_4(x)
        ctx = self.ConvBN_5(ctx)
        ctx = self.ConvBN_6(ctx)
        up = resize_bilinear(ctx, detail.shape[-2], detail.shape[-1])
        up = self.ConvBN_7(up)
        fused = self.ConvBN_8(torch.relu(detail + up))
        logits = self.Conv_0(fused)
        return resize_bilinear(logits, x.shape[-2] * 8 // 2,
                               x.shape[-1] * 8 // 2)

    def forward(self, rgb):
        return self.logits_nchw(rgb).permute(0, 2, 3, 1)


def _init_weights(model: DDRNetSlim, generator=None):
    """flax's initializers: convolution kernels LeCun-normal (a normal of
    variance 1/fan_in truncated at ±2σ, rescaled to keep that variance),
    biases zero, GroupNorm scales one and biases zero."""
    for m in model.modules():
        if isinstance(m, Conv):
            fan_in = m.weight.shape[1] * m.kernel * m.kernel
            std = (1.0 / fan_in) ** 0.5 / .87962566103423978
            with torch.no_grad():
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)


def init_segmenter(height: int = 480, width: int = 640,
                   num_classes: int = 19, net_width: int = 32,
                   generator=None, device="cuda"):
    """Build (module, params) for an RGB (B, H, W, 3) input: params is the
    module's state dict, its tensors on ``device`` (the height and width
    fix no weight; they are kept for the JAX package's signature)."""
    del height, width
    model = DDRNetSlim(num_classes=num_classes, width=net_width)
    _init_weights(model, generator)
    model = model.to(device).eval()
    return model, {k: v.detach() for k, v in model.state_dict().items()}


def full_logits(model, params, rgb):
    """Logits (B, C, H, W) f32 at the input's resolution: the model's 1/2
    logits resized again in f32, as ``infer_classes`` and the loss take
    them."""
    rgb = torch.as_tensor(rgb, dtype=torch.float32)
    if params is None or params is model:
        logits = model.logits_nchw(rgb)
    else:
        logits = torch.func.functional_call(model, params, (rgb,)).permute(
            0, 3, 1, 2)
    h, w = rgb.shape[1:3]
    return resize_bilinear(logits, h, w, fused_h=False)


@torch.no_grad()
def infer_classes(model: DDRNetSlim, params, rgb):
    """bf16 forward pass → (B, H, W) int32 class ids (the reference's
    ``np.argmax(output, axis=1)``, `trt_interface.py:70-78`); ``argmax``
    takes the first of equal maxima, as ``jnp.argmax`` does. ``params``:
    a state dict for ``model``, or None (or the module) for its own."""
    return full_logits(model, params, rgb).argmax(dim=1).int()


def load_class_map_csv(path: str):
    """Ingest the reference's class-map CSVs
    (`data/colors_mapillary*.csv`, semicolon ``color;description`` rows;
    row order = class id, matching `trt_interface.py`'s argmax ids).
    Returns (names list, (C, 3) uint8 color table)."""
    names, colors = [], []
    with open(path) as f:
        header = f.readline()
        assert "color" in header and "description" in header, header
        for line in f:
            line = line.strip()
            if not line:
                continue
            color_s, name = line.split(";")
            colors.append([int(t) for t in color_s.split()])
            names.append(name.strip())
    return names, np.asarray(colors, np.uint8)


def colorize_classes(class_mask, color_table):
    """(H, W) class ids → (H, W, 3) uint8 through an ingested class map
    (ids clipped into the table), on ``class_mask``'s device."""
    mask = torch.as_tensor(class_mask)
    ct = torch.as_tensor(np.asarray(color_table), device=mask.device)
    return ct[torch.clamp(mask.long(), 0, ct.shape[0] - 1)]


def segmentation_to_pointcloud(depth, class_mask, fx, fy, cx, cy,
                               keep_classes=None, depth_scale: float = 1.0):
    """`semantic_segmentation2point_cloud.cpp:81-176`: depth (H, W) + class
    mask (H, W) → (H·W, 4) xyz+class cloud (intensity = class id) and a
    validity mask. ``keep_classes``: class ids to keep — points of other
    classes are masked out (the reference publishes one cloud per
    configured class)."""
    pts, valid = depth_image_to_points(depth, fx, fy, cx, cy, depth_scale)
    ids = class_mask.reshape(-1)
    if keep_classes is not None:
        keep = torch.as_tensor(np.asarray(keep_classes), device=ids.device)
        valid = valid & torch.isin(ids, keep.to(ids.dtype))
    return torch.cat([pts, ids.float()[:, None]], dim=-1), valid


# ---------------------------------------------------------------------------
# weights: the npz artifact (flax's key strings) and the train step
# ---------------------------------------------------------------------------

def flax_key(name: str) -> str:
    """The JAX package's npz key of one of the port's state-dict entries:
    ``ConvBN_0.Conv_0.weight`` → ``['params']['ConvBN_0']['Conv_0']
    ['kernel']`` (``jax.tree_util.keystr`` of the flax params path)."""
    parts = name.split(".")
    leaf = {"weight": "kernel"}.get(parts[-1], parts[-1])
    return "['params']" + "".join(f"['{p}']" for p in parts[:-1] + [leaf])


def to_flax_array(name: str, t) -> np.ndarray:
    """A state-dict tensor as the flax leaf: convolution weights OIHW →
    HWIO."""
    a = t.detach().cpu().numpy()
    return a.transpose(2, 3, 1, 0) if name.endswith(".weight") else a


def from_flax_array(name: str, a) -> np.ndarray:
    """A flax leaf as the state-dict array (a copy): kernels HWIO →
    OIHW."""
    a = np.array(a, np.float32)
    return np.ascontiguousarray(
        a.transpose(3, 2, 0, 1) if name.endswith(".weight") else a)


def save_params(path: str, params) -> None:
    """Serialize weights in the JAX package's npz format (flax key strings,
    HWIO kernels): a file the JAX package's ``load_params`` reads."""
    np.savez_compressed(path, **{flax_key(k): to_flax_array(k, v)
                                 for k, v in params.items()})


def load_params(path: str, template_params):
    """Restore weights (the JAX package's npz, or one :func:`save_params`
    wrote) into a state dict shaped and placed like ``template_params``."""
    with np.load(path) as data:
        return {k: torch.as_tensor(from_flax_array(k, data[flax_key(k)]),
                                   dtype=t.dtype, device=t.device)
                for k, t in template_params.items()}


def softmax_ce_loss(model, params, rgb, labels, ignore_id: int = 255,
                    class_weights=None):
    """Per-pixel cross entropy with an ignore label (the Mapillary/
    Cityscapes convention the reference's class CSVs follow), weighted by
    ``class_weights`` (C,) where given; the logits resized to the labels'
    resolution first."""
    logits = full_logits(model, params, rgb)
    logp = torch.log_softmax(logits.float(), dim=1)
    labels = torch.as_tensor(labels, device=logp.device).long()
    valid = labels != ignore_id
    safe = torch.where(valid, labels, 0)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    w = valid.float()
    if class_weights is not None:
        w = w * torch.as_tensor(np.asarray(class_weights), dtype=torch.float32,
                                device=w.device)[safe]
    return (nll * w).sum() / torch.clamp_min(w.sum(), 1e-6)


def make_train_step(model, learning_rate=1e-3, class_weights=None):
    """Returns (opt_state_init, step): step(params, opt_state, rgb, labels)
    → (params, opt_state, loss), as the JAX package's. Adam with optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8); ``learning_rate`` a float or a
    callable of the step count (an optax schedule)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr_of = learning_rate if callable(learning_rate) else (
        lambda count: learning_rate)

    def init(params):
        return {"count": 0,
                "mu": {k: torch.zeros_like(v) for k, v in params.items()},
                "nu": {k: torch.zeros_like(v) for k, v in params.items()}}

    def step(params, opt_state, rgb, labels):
        names = list(params)
        leaves = [params[k].detach().requires_grad_(True) for k in names]
        with torch.enable_grad():
            loss = softmax_ce_loss(model, dict(zip(names, leaves)), rgb,
                                   labels, class_weights=class_weights)
            grads = torch.autograd.grad(loss, leaves)
        count = opt_state["count"] + 1
        lr = float(lr_of(opt_state["count"]))
        c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        new_p, mu, nu = {}, {}, {}
        with torch.no_grad():
            for k, p, g in zip(names, leaves, grads):
                mu[k] = (1.0 - b1) * g + b1 * opt_state["mu"][k]
                nu[k] = (1.0 - b2) * g * g + b2 * opt_state["nu"][k]
                upd = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
                new_p[k] = p.detach() - lr * upd
        return new_p, {"count": count, "mu": mu, "nu": nu}, loss.detach()

    return init, step
