"""Carrying state between the JAX package and the port, as numpy arrays.

The local-planner slice has no learned parameters: plans, poses,
velocities and obstacle clouds are its whole state. :func:`to_port` turns
one of the JAX package's NamedTuples (``GlobalPlan``, ``FleetState``, ...)
whose leaves were read out with ``np.asarray`` into the port's NamedTuple
of the same field names, on a given device; :func:`to_numpy` turns port
outputs back into numpy.
"""
from __future__ import annotations

import numpy as np
import torch


def tensor(x, device) -> torch.Tensor:
    """A copy of a numpy array (or array-like) as a tensor on ``device``:
    floats as f32, integers as int64, bools as bool."""
    a = np.asarray(x)
    if a.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dtype = torch.int64
    else:
        dtype = torch.float32
    return torch.tensor(a, dtype=dtype, device=device)


def to_port(src, cls, device):
    """``cls(**{f: tensor(src.f)})`` for each field of the port NamedTuple
    ``cls``; ``src`` is any object with those attributes."""
    return cls(**{f: tensor(getattr(src, f), device) for f in cls._fields})


def to_numpy(x):
    """Tensors, and NamedTuples, tuples, lists and dicts of them, as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return x
