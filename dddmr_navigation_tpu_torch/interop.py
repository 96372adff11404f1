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
filter and its draws, or the port's, as numpy by name);
:func:`port_seed_draws` and :func:`port_tick_of_one` read a global
localization's (one robot whose particle count changes tick by tick).
:func:`feature_set_fields`, :func:`pose_graph_fields`,
:func:`keyframe_fields` and :func:`mapping_fields` read a SLAM frontend's
features, a padded pose graph and a mapping session's state as numpy;
:func:`port_feature_set`, :func:`port_pose_graph` and
:func:`port_mapping_state` build the port's from them.
:func:`semantic_params_from` builds the port's segmenter state dict from the
JAX package's flax weights (a params tree or its npz) and
:func:`semantic_params_to` goes back.
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


def port_seed_draws(record, device):
    """The global-localization seed's draws (``node_idx``, ``yaw_idx`` of
    a record: the ground nodes and yaw cells the JAX package's
    ``seed_global_state`` drew) as the port's ``SeedDraws``."""
    from dddmr_navigation_tpu_torch.state_estimation.global_localization \
        import SeedDraws
    return SeedDraws(
        node_idx=torch.as_tensor(np.asarray(record["node_idx"], np.int64),
                                 device=device),
        yaw_idx=torch.as_tensor(np.asarray(record["yaw_idx"], np.int64),
                                device=device))


def port_tick_of_one(tick: dict, device):
    """One tick of a fleet-of-one record (a dict by :data:`DRAW_KEYS` and
    :func:`mcl_fields` names, as ``pack_ticks``/``tick_of`` give it,
    whatever the tick's particle count): (the MCLState the tick started
    from, its ``pf.MCLDraws``), each with the robot axis B = 1."""
    one = {k: np.asarray(v)[None] for k, v in tick.items()}
    return (port_mcl_state({k: v[None] for k, v in one.items()
                            if k.startswith("mcl_")}, 0, device),
            port_draws(one, device))


# ---------------------------------------------------------------------------
# the navigation session's state (control.session.NavigationSession)
# ---------------------------------------------------------------------------

def _np(x):
    return np.asarray(to_numpy(x))


def _sparse(prefix, dense, fill, out):
    flat = _np(dense).reshape(-1)
    idx = np.flatnonzero(flat != fill).astype(np.int32)
    out[f"{prefix}_idx"] = idx
    out[f"{prefix}_val"] = flat[idx]


def _path(prefix, positions, quats, out):
    """A host path (or None) as its (n, 3) positions and (n, 4) quats; a
    missing path has ``{prefix}_on`` False and n = 0."""
    out[f"{prefix}_on"] = np.asarray(positions is not None)
    out[f"{prefix}_pos"] = (np.zeros((0, 3), np.float32) if positions is None
                            else _np(positions).reshape(-1, 3))
    out[f"{prefix}_quat"] = (np.zeros((0, 4), np.float32) if quats is None
                             else _np(quats).reshape(-1, 4))


def _marking(prefix, m, fill, out):
    _sparse(f"{prefix}_grid", m.grid, 0, out)
    _sparse(f"{prefix}_dgraph", m.dgraph, fill, out)
    out[f"{prefix}_origin"] = _np(m.origin).reshape(3)
    out[f"{prefix}_clear_offset"] = _np(m.clear_offset).reshape(())


def session_fields(sess) -> dict:
    """What a navigation session (the JAX package's or the port's: the
    same attribute names) carries from tick to tick, as numpy by name,
    for the golden files that hold the two packages to each other: its
    ``checkpoint_state()`` (the marking grids and fields stored sparse,
    the FSM, the move-base field, the depth ring's slots except their
    points, which the frames pushed give back), the adopted plan, the
    recovery, the plan manager's and the DWA manager's caches and timers,
    and the session's host clocks. :func:`port_session_state` turns it
    back into the port's state. The port's own complete form of that
    state, tensors and all, is ``control.session.SessionState``
    (``NavigationSession.state()``; the lidar stitcher's ring and the
    no-entry toggle are there too)."""
    fill = float(sess.cfg.perception.max_obstacle_distance)
    d = sess.driver
    pm, dwa = d.plan_manager, d.plan_manager.dwa
    out = {"ground_nodes": np.asarray(len(sess.ground)),
           "grid_shape": np.asarray(_np(sess.marking.grid).shape[-3:]),
           "dgraph_fill": np.asarray(fill, np.float32)}
    _marking("marking", sess.marking, fill, out)
    _sparse("driver_dgraph", d.dgraph, fill, out)
    for f in ("decision", "last_valid_plan", "last_valid_control",
              "last_oscillation_reset", "oscillation_pos", "oscillation_yaw",
              "waiting_time", "no_plan_recovery_count"):
        out[f"fsm_{f}"] = _np(getattr(d.fsm, f)).reshape(
            (3,) if f == "oscillation_pos" else ())
    if getattr(sess, "n_depth_cameras", 0) > 0:
        _marking("depth_marking", sess.depth_marking, fill, out)
        buf = sess.depth_buffer
        c, n = _np(buf.stamp).shape[-2:]
        out["depth_buffer_stamp"] = _np(buf.stamp).reshape(c, n)
        out["depth_buffer_head"] = _np(buf.head).reshape(c)
        out["depth_buffer_cam_pos"] = _np(buf.cam_pos).reshape(c, n, 3)
        out["depth_buffer_cam_quat"] = _np(buf.cam_quat).reshape(c, n, 4)
        out["depth_buffer_mask"] = _np(buf.mask).reshape(c, n, -1)
    plan = d.plan
    if plan is None:
        _path("plan", None, None, out)
    else:
        k = int(_np(plan.count).reshape(()))
        _path("plan", _np(plan.positions).reshape(-1, 3)[:k],
              _np(plan.quats).reshape(-1, 4)[:k], out)
    rec = d.recovery
    out["recovery_on"] = np.asarray(rec is not None)
    out["recovery_start_yaw"] = np.asarray(
        0.0 if rec is None else _np(rec.start_yaw).reshape(()), np.float32)
    out["recovery_got_180"] = np.asarray(
        False if rec is None else bool(_np(rec.got_180).reshape(())))
    out["recovery_succeed"] = np.asarray(bool(d.recovery_succeed))
    cached = pm._plan
    _path("pm_plan", None if cached is None else cached.positions,
          None if cached is None else cached.quats, out)
    out["pm_fresh"] = np.asarray(bool(pm._fresh))
    out["pm_empty_result"] = np.asarray(bool(pm._empty_result))
    out["pm_last_query_t"] = np.asarray(pm._last_query_t, np.float64)
    out["pm_active"] = np.asarray(bool(pm.active))
    goal = dwa.current_goal
    out["dwa_goal_on"] = np.asarray(goal is not None)
    out["dwa_goal_pos"] = (np.zeros(3, np.float32) if goal is None
                           else np.asarray(goal[0], np.float32))
    out["dwa_goal_quat"] = (np.zeros(4, np.float32) if goal is None
                            else np.asarray(goal[1], np.float32))
    for name in ("global_path", "dwa_path"):
        p = getattr(dwa, name)
        _path(f"dwa_{name}", None if p is None else p.positions,
              None if p is None else p.quats, out)
    out["dwa_threading_active"] = np.asarray(bool(dwa.threading_active))
    out["dwa_last_recompute_t"] = np.asarray(dwa.last_recompute_t,
                                             np.float64)
    out["last_perception_t"] = np.asarray(sess._last_perception_t,
                                          np.float64)
    for k in ("scan", "odom"):
        out[f"gate_{k}"] = np.asarray(sess.gate._last.get(k, np.nan),
                                      np.float64)
    return out


def _dense(f, prefix, shape, fill, dtype, device):
    flat = np.full(int(np.prod(shape)), fill, dtype)
    flat[f[f"{prefix}_idx"]] = f[f"{prefix}_val"]
    return tensor(flat.reshape((1,) + tuple(shape)), device)


def port_session_state(f: dict, device, depth_points=None) -> dict:
    """The port's session state from :func:`session_fields` (of the JAX
    package's session or the port's), for ``NavigationSession.
    restore_state``: the checkpoint dict (B = 1) plus ``"host"``, the
    adopted plan (a ``CachedPlan``), the recovery, the manager caches and
    the clocks.
    ``depth_points`` (C, N, P, 3) are the depth ring's points (the frames
    pushed into its slots)."""
    from dddmr_navigation_tpu_torch.control.fsm import FSMState
    from dddmr_navigation_tpu_torch.control.recovery import (
        RotateRecoveryState)
    from dddmr_navigation_tpu_torch.perception.depth_camera import (
        DepthCameraBuffer)
    from dddmr_navigation_tpu_torch.perception.marking import MarkingState
    from dddmr_navigation_tpu_torch.planning.global_.dwa import CachedPlan

    g = int(f["ground_nodes"])
    shape = tuple(int(x) for x in f["grid_shape"])
    fill = float(f["dgraph_fill"])

    def marking(prefix):
        return MarkingState(
            grid=_dense(f, f"{prefix}_grid", shape, 0, np.uint8, device),
            origin=tensor(f[f"{prefix}_origin"].astype(np.int32)[None],
                          device),
            dgraph=_dense(f, f"{prefix}_dgraph", (g,), fill, np.float32,
                          device),
            clear_offset=tensor(np.asarray(
                f[f"{prefix}_clear_offset"], np.int32).reshape(1), device))

    fsm = FSMState(**{k: tensor(np.asarray(f[f"fsm_{k}"])[None], device)
                      for k in FSMState._fields})
    fsm = fsm._replace(decision=fsm.decision.int(),
                       no_plan_recovery_count=fsm.no_plan_recovery_count.int())
    state = {"marking": marking("marking"), "fsm": fsm,
             "dgraph": _dense(f, "driver_dgraph", (g,), fill, np.float32,
                              device)[0]}
    if "depth_marking_origin" in f:
        state["depth_marking"] = marking("depth_marking")
        mask = f["depth_buffer_mask"]
        pts = (np.zeros(mask.shape + (3,), np.float32) if depth_points is None
               else np.asarray(depth_points, np.float32))
        state["depth_buffer"] = DepthCameraBuffer(
            cam_pos=tensor(f["depth_buffer_cam_pos"][None], device),
            cam_quat=tensor(f["depth_buffer_cam_quat"][None], device),
            points=tensor(pts[None], device), mask=tensor(mask[None], device),
            stamp=tensor(f["depth_buffer_stamp"][None], device),
            head=tensor(f["depth_buffer_head"].astype(np.int32)[None],
                        device))

    def path(prefix):
        if not bool(f[f"{prefix}_on"]):
            return None
        return CachedPlan(np.asarray(f[f"{prefix}_pos"], np.float32),
                          np.asarray(f[f"{prefix}_quat"], np.float32))

    recovery = None
    if bool(f["recovery_on"]):
        recovery = RotateRecoveryState(
            start_yaw=tensor(np.asarray(f["recovery_start_yaw"],
                                        np.float32).reshape(1), device),
            got_180=tensor(np.asarray(f["recovery_got_180"]).reshape(1),
                           device),
            active=tensor(np.ones(1, bool), device))
    goal = None
    if bool(f["dwa_goal_on"]):
        goal = (np.asarray(f["dwa_goal_pos"], np.float32),
                np.asarray(f["dwa_goal_quat"], np.float32))
    gate = {k: float(f[f"gate_{k}"]) for k in ("scan", "odom")
            if np.isfinite(f[f"gate_{k}"])}
    state["host"] = {
        "plan": path("plan"), "recovery": recovery,
        "recovery_succeed": bool(f["recovery_succeed"]),
        "pm_plan": path("pm_plan"), "pm_fresh": bool(f["pm_fresh"]),
        "pm_empty_result": bool(f["pm_empty_result"]),
        "pm_last_query_t": float(f["pm_last_query_t"]),
        "pm_active": bool(f["pm_active"]),
        "dwa_current_goal": goal,
        "dwa_global_path": path("dwa_global_path"),
        "dwa_path": path("dwa_dwa_path"),
        "dwa_threading_active": bool(f["dwa_threading_active"]),
        "dwa_last_recompute_t": float(f["dwa_last_recompute_t"]),
        "last_perception_t": float(f["last_perception_t"]),
        "gate_last": gate}
    return state


def pack_ticks(records: list, prefix: str = "") -> dict:
    """Per-tick dicts of numpy arrays stacked over ticks, each key stored
    as ``prefix + key``: a key whose arrays differ in shape is
    concatenated along axis 0, with its per-tick lengths under
    ``{prefix}{key}__len``. :func:`tick_of` unpacks tick t."""
    out = {}
    for k in records[0]:
        arrs = [np.asarray(r[k]) for r in records]
        if all(a.shape == arrs[0].shape for a in arrs):
            out[prefix + k] = np.stack(arrs)
        else:
            out[prefix + k] = np.concatenate(arrs)
            out[f"{prefix}{k}__len"] = np.asarray([len(a) for a in arrs],
                                                  np.int64)
    return out


def tick_of(packed, t: int, prefix: str = "", keys=None) -> dict:
    """Tick ``t``'s dict of a :func:`pack_ticks` record stored under
    ``prefix`` (``keys``: the names to read, default all), without the
    prefix."""
    names = keys or [k[len(prefix):] for k in packed.keys()
                     if k.startswith(prefix) and not k.endswith("__len")]
    out = {}
    for k in names:
        key = prefix + k
        if f"{key}__len" in packed:
            lens = packed[f"{key}__len"]
            start = int(lens[:t].sum())
            out[k] = packed[key][start:start + int(lens[t])]
        else:
            out[k] = packed[key][t]
    return out


# ---------------------------------------------------------------------------
# the mapping session's state (slam.pipeline.MappingSession)
# ---------------------------------------------------------------------------

_FEATURE_FIELDS = ("sharp", "sharp_mask", "less_sharp", "less_sharp_mask",
                   "flat", "flat_mask", "less_flat", "less_flat_mask",
                   "less_sharp_ring", "less_flat_ring", "less_flat_ground")
_GRAPH_FIELDS = ("pos", "quat", "node_mask", "edge_i", "edge_j", "edge_pos",
                 "edge_quat", "edge_weight")
_SUBMAP_FIELDS = ("submap_sharp", "submap_sharp_m", "submap_flat",
                  "submap_flat_m")


def feature_set_fields(f, prefix: str = "") -> dict:
    """A LOAM ``FeatureSet`` (the JAX package's or the port's: the same
    field names) as numpy by ``prefix + field``."""
    return {prefix + k: _np(getattr(f, k)) for k in _FEATURE_FIELDS}


def port_feature_set(record, device, prefix: str = ""):
    """The port's ``slam.features.FeatureSet`` from a record of
    :func:`feature_set_fields`."""
    from dddmr_navigation_tpu_torch.slam.features import FeatureSet
    return FeatureSet(*(tensor(record[prefix + k], device)
                        for k in _FEATURE_FIELDS))


def pose_graph_fields(g, prefix: str = "graph_") -> dict:
    """A padded pose graph (``PoseGraphArrays``, either package's) as
    numpy by ``prefix + field``."""
    return {prefix + k: _np(getattr(g, k)) for k in _GRAPH_FIELDS}


def port_pose_graph(record, device, prefix: str = "graph_"):
    """The port's ``slam.pose_graph.PoseGraphArrays`` from a record of
    :func:`pose_graph_fields`."""
    from dddmr_navigation_tpu_torch.slam.pose_graph import PoseGraphArrays
    return PoseGraphArrays(*(tensor(record[prefix + k], device)
                             for k in _GRAPH_FIELDS))


def keyframe_fields(sess) -> dict:
    """A mapping session's keyframes as numpy: each ``FeatureSet`` field
    stacked over keyframes (``kf_<field>``), and the patched ground and
    ground-edge clouds concatenated (``kf_ground``, ``kf_ground_edge``,
    with per-keyframe lengths under ``__len``; a keyframe recorded without
    a scan has empty clouds). A keyframe never changes once added, so a
    record can hold them once."""
    feats = [to_numpy(f) for f in sess.keyframe_feats]
    out = {f"kf_{k}": np.stack([np.asarray(getattr(f, k)) for f in feats])
           for k in _FEATURE_FIELDS} if feats else {}
    for name in ("ground", "ground_edge"):
        clouds = [np.zeros((0, 3), np.float32) if c is None
                  else np.asarray(c, np.float32)
                  for c in getattr(sess, f"keyframe_{name}")]
        out[f"kf_{name}"] = (np.concatenate(clouds) if clouds
                             else np.zeros((0, 3), np.float32))
        out[f"kf_{name}__len"] = np.asarray([len(c) for c in clouds],
                                            np.int64)
    return out


def mapping_fields(sess, keyframes: bool = True) -> dict:
    """What a mapping session (either package's: the same attribute
    names) carries from scan to scan, as numpy by name: the current pose,
    the counts, the padded graph (``graph_*``), the loop closures ((L, 3):
    i, j, fitness), the submap (``submap_*``, absent when there is none)
    and, with ``keyframes``, :func:`keyframe_fields`."""
    out = {"cur_pos": np.asarray(sess.cur_pos, np.float32),
           "cur_quat": np.asarray(sess.cur_quat, np.float32),
           "n_keyframes": np.int64(sess.n_keyframes),
           "n_edges": np.int64(sess.n_edges),
           "paused": np.bool_(sess.paused),
           "loop_closures": np.asarray(
               [(i, j, f) for i, j, f in sess.loop_closures],
               np.float64).reshape(-1, 3)}
    out.update(pose_graph_fields(sess.graph))
    if sess._submap is not None:
        out.update({k: _np(v) for k, v in zip(_SUBMAP_FIELDS,
                                              sess._submap)})
    if keyframes:
        out.update(keyframe_fields(sess))
    return out


def port_mapping_state(f: dict, cfg, device, keyframes: dict = None):
    """The port's ``slam.pipeline.MappingSession`` in the state of a
    :func:`mapping_fields` record ``f``, on ``device``: its first
    ``n_keyframes`` keyframes from ``f``'s ``kf_*`` arrays or from
    ``keyframes`` (a :func:`keyframe_fields` record of at least as many
    keyframes); the submap from ``f``, or rebuilt from the keyframes and
    the graph where ``f`` has none (between a keyframe and the next, the
    submap is the rebuild of the state)."""
    from dddmr_navigation_tpu_torch.slam.features import FeatureSet
    from dddmr_navigation_tpu_torch.slam.pipeline import MappingSession
    kf = f if keyframes is None else keyframes
    n = int(f["n_keyframes"])
    sess = MappingSession(cfg=cfg, device=device,
                          graph=port_pose_graph(f, device))
    sess.cur_pos = np.array(f["cur_pos"], np.float32)
    sess.cur_quat = np.array(f["cur_quat"], np.float32)
    sess.n_keyframes = n
    sess.n_edges = int(f["n_edges"])
    sess.paused = bool(f["paused"])
    sess.loop_closures = [(int(i), int(j), float(x))
                          for i, j, x in np.asarray(f["loop_closures"])]
    for i in range(n):
        host = FeatureSet(*(np.array(kf[f"kf_{k}"][i])
                            for k in _FEATURE_FIELDS))
        sess.keyframe_host.append(host)
        sess.keyframe_feats.append(FeatureSet(*(tensor(x, device)
                                                for x in host)))
    for name in ("ground", "ground_edge"):
        lens = np.asarray(kf[f"kf_{name}__len"])
        starts = np.concatenate([[0], np.cumsum(lens)])
        getattr(sess, f"keyframe_{name}").extend(
            np.array(kf[f"kf_{name}"][starts[i]:starts[i + 1]], np.float32)
            for i in range(n))
    if _SUBMAP_FIELDS[0] in f:
        sess._submap = tuple(tensor(f[k], device) for k in _SUBMAP_FIELDS)
    else:
        sess._rebuild_submap()
    return sess


def _flax_tree_items(tree, prefix=""):
    """(keystr, leaf) of a nested dict of arrays, ``jax.tree_util.keystr``
    style: ``['params']['ConvBN_0']['Conv_0']['kernel']``."""
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}['{k}']"
        if isinstance(v, dict):
            yield from _flax_tree_items(v, key)
        else:
            yield key, v


def semantic_params_from(tree_or_npz, device="cuda") -> dict:
    """The port's ``DDRNetSlim`` state dict from the JAX package's segmenter
    weights: a flax params tree read out as numpy (``{'params': {...}}``)
    or the npz dict the JAX package's ``save_params`` writes (keys
    ``['params']['ConvBN_0']['Conv_0']['kernel']``, ...). Kernels HWIO →
    OIHW; GroupNorm scales and biases and the logits bias as they are."""
    from dddmr_navigation_tpu_torch.perception.semantic import (
        from_flax_array)
    if isinstance(tree_or_npz, dict) and "params" in tree_or_npz:
        flat = dict(_flax_tree_items(tree_or_npz))
    else:
        flat = {k: tree_or_npz[k] for k in tree_or_npz}
    out = {}
    for key, v in flat.items():
        parts = key.strip("[]'").split("']['")[1:]      # drop 'params'
        leaf = {"kernel": "weight"}.get(parts[-1], parts[-1])
        name = ".".join(parts[:-1] + [leaf])
        out[name] = torch.as_tensor(from_flax_array(name, v), device=device)
    return out


def semantic_params_to(state_dict) -> dict:
    """The inverse of :func:`semantic_params_from`: a flax params tree of
    numpy arrays (``{'params': {'ConvBN_0': {'Conv_0': {'kernel': ...}}}}``)
    from the port's state dict."""
    from dddmr_navigation_tpu_torch.perception.semantic import to_flax_array
    tree = {}
    for name, t in state_dict.items():
        parts = name.split(".")
        leaf = {"weight": "kernel"}.get(parts[-1], parts[-1])
        node = tree.setdefault("params", {})
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = to_flax_array(name, t)
    return tree
