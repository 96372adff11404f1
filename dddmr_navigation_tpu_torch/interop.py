"""Carrying state between the JAX package and the port, as numpy arrays.

:func:`to_port` turns one of the JAX package's NamedTuples or dataclasses
(``GlobalPlan``, ``FleetState``, ``FusedMap``, ``FusedState``,
``MarkingState``, ``MapContext``, ...) whose leaves were read out with
``np.asarray`` into the port's class of the same field names, on a given
device: nested NamedTuples and dataclasses field by field, by the port
class's annotations. :func:`to_numpy` turns port outputs back into numpy.
:func:`config_from` rebuilds one of the port's config dataclasses from a
config of the same field names (the JAX package's, say), by name alone.
:func:`fleet_full_state_from` builds the full fleet tick's state (its FSM,
recovery and MCL states included; the JAX filter's random key is dropped,
since the port takes its draws as arguments). :data:`DRAW_KEYS`,
:func:`mcl_fields`, :func:`port_mcl_state` and :func:`port_draws` read and
write the MCL states and draws of a golden record (the JAX package's
filter and its draws, or the port's, as numpy by name).
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

# One MCL update's unit draws in a golden record, in ``pf.MCLDraws``'s order.
DRAW_KEYS = ("u", "res_pos", "res_rpy", "exp_pos", "exp_rpy", "odom")

# Kept as they are; other integers become int64, floats f32.
_KEPT = {np.dtype(np.bool_): torch.bool, np.dtype(np.uint8): torch.uint8,
         np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
         np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64}


def tensor(x, device) -> torch.Tensor:
    """A copy of a numpy array (or array-like) as a tensor on ``device``:
    bool, uint8, int8, int16, int32 and int64 keep their type (a uint8
    voxel grid stays one byte a cell), other integers become int64 and
    floats f32."""
    a = np.asarray(x)
    dtype = _KEPT.get(a.dtype)
    if dtype is None:
        dtype = (torch.int64 if np.issubdtype(a.dtype, np.integer)
                 else torch.float32)
    return torch.tensor(a, dtype=dtype, device=device)


def _struct_class(hint):
    """The NamedTuple or dataclass in a field annotation (unwrapping
    Optional), or None."""
    for h in (hint, *typing.get_args(hint)):
        if isinstance(h, type) and (hasattr(h, "_fields")
                                    or dataclasses.is_dataclass(h)):
            return h
    return None


def to_port(src, cls, device):
    """``cls`` built field by field from the same-named attributes of
    ``src``: nested NamedTuples and dataclasses recursively, Python scalar
    fields (a dataclass's static metadata) as they are, None as None,
    arrays through :func:`tensor`."""
    hints = typing.get_type_hints(cls)
    names = (cls._fields if hasattr(cls, "_fields")
             else [f.name for f in dataclasses.fields(cls)])
    out = {}
    for name in names:
        value, hint = getattr(src, name), hints.get(name)
        sub = _struct_class(hint)
        if value is None:
            out[name] = None
        elif sub is not None:
            out[name] = to_port(value, sub, device)
        elif hint in (int, float, bool):
            out[name] = hint(value)
        else:
            out[name] = tensor(value, device)
    return cls(**out)


def to_numpy(x):
    """Tensors, and NamedTuples, dataclasses, tuples, lists and dicts of
    them, as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_numpy(v) for v in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x)(**{f.name: to_numpy(getattr(x, f.name))
                          for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(to_numpy(v) for v in x)
    if isinstance(x, dict):
        return {k: to_numpy(v) for k, v in x.items()}
    return x


def config_from(obj):
    """The port's config dataclass of the same class name as ``obj`` (any
    dataclass instance with the same field names, such as one of the JAX
    package's configs), built from ``obj``'s fields read by name: nested
    dataclasses recursively, every other value as it is."""
    from dddmr_navigation_tpu_torch.config import schema
    cls = getattr(schema, type(obj).__name__)
    out = {}
    for f in dataclasses.fields(cls):
        value = getattr(obj, f.name)
        if dataclasses.is_dataclass(value) and not isinstance(value, type):
            value = config_from(value)
        out[f.name] = value
    return cls(**out)


def fleet_full_state_from(src, device):
    """The port's ``parallel.fleet.FleetFullState`` from the same-named
    fields of ``src`` (the JAX package's FleetFullState read out with
    ``np.asarray``): the fused, FSM, recovery and MCL states through
    :func:`to_port` into their port classes, the rest as tensors."""
    from dddmr_navigation_tpu_torch.control.fsm import FSMState
    from dddmr_navigation_tpu_torch.control.fused import FusedState
    from dddmr_navigation_tpu_torch.control.recovery import (
        RotateRecoveryState)
    from dddmr_navigation_tpu_torch.parallel.fleet import FleetFullState
    from dddmr_navigation_tpu_torch.state_estimation.mcl import MCLState
    sub = {"fused": FusedState, "fsm": FSMState,
           "recovery": RotateRecoveryState, "mcl": MCLState}
    out = {}
    for name in FleetFullState._fields:
        value = getattr(src, name)
        if value is None:
            out[name] = None
        elif name in sub:
            out[name] = to_port(value, sub[name], device)
        else:
            out[name] = tensor(value, device)
    return FleetFullState(**out)


def mcl_fields(mcl) -> dict:
    """An MCLState's arrays (the JAX package's or the port's, its random
    key left out) by ``mcl_``-prefixed field path: ``mcl_particles_pos``,
    ``mcl_state_prev_pos``, ``mcl_f_pos_x``, ..."""
    out = {}
    for name in ("particles", "f_pos", "f_ang"):
        sub = getattr(mcl, name)
        for f in sub._fields:
            out[f"mcl_{name}_{f}"] = np.asarray(to_numpy(getattr(sub, f)))
    for f in ("state_prev_pos", "state_prev_quat"):
        out[f"mcl_{f}"] = np.asarray(to_numpy(getattr(mcl, f)))
    return out


def port_mcl_state(record, t: int, device):
    """The port's MCLState of tick ``t`` of a record of :func:`mcl_fields`
    stacked over ticks (a golden file)."""
    from dddmr_navigation_tpu_torch.state_estimation.mcl import Lpf3, MCLState
    from dddmr_navigation_tpu_torch.state_estimation.pf import PFState

    def a(k):
        return torch.as_tensor(record[f"mcl_{k}"][t], device=device)
    return MCLState(
        particles=PFState(*(a(f"particles_{f}") for f in PFState._fields)),
        state_prev_pos=a("state_prev_pos"),
        state_prev_quat=a("state_prev_quat"),
        f_pos=Lpf3(a("f_pos_x"), a("f_pos_out")),
        f_ang=Lpf3(a("f_ang_x"), a("f_ang_out")))


def port_draws(draws, device):
    """The port's ``pf.MCLDraws`` from one update's draws by
    :data:`DRAW_KEYS`."""
    from dddmr_navigation_tpu_torch.state_estimation.pf import MCLDraws
    return MCLDraws(*(torch.as_tensor(draws[k], device=device)
                      for k in DRAW_KEYS))
