"""Checks and launch plumbing shared by the kernel wrappers."""
from __future__ import annotations

import torch

from dddmr_navigation_tpu_torch.ops.build import load_library


def raise_unless_cpu(t: torch.Tensor) -> None:
    """Only CPU tensors may take a plain version; anything else raises."""
    if t.device.type != "cpu":
        raise ValueError(f"no kernel for tensors on {t.device}")


def check_cuda_inputs(*specs) -> None:
    """Raise unless every (tensor, shape, dtype) in ``specs`` is a
    contiguous tensor of that shape and dtype on the first one's CUDA
    device."""
    device = specs[0][0].device
    for t, shape, dtype in specs:
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, expected {device}")
        if t.dtype != dtype:
            raise TypeError(f"tensor of {t.dtype}, expected {dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"tensor of shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if max((t.numel() for t, _, _ in specs)) >= 2 ** 31:
        raise ValueError("kernel inputs must hold fewer than 2**31 elements")


def launch(name: str, *args) -> None:
    """Call the library's entry point ``name`` on the current stream of the
    first tensor's device. Tensors are passed as data pointers; the
    entry point returns the launch's cudaError_t, and a non-zero code
    raises."""
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args]
        err = getattr(lib, name)(*c_args, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed to launch: cudaError_t {err}")
