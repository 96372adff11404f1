"""ctypes bindings for the native host runtime (native/dddmr_host.cpp):
C++ PCD loading, spatial-hash kNN graph construction, and the SPSC ring
transport. Auto-builds the shared library on first use (g++ is part of
the toolchain); every entry point has a NumPy/SciPy fallback so the pure-
Python path keeps working where a compiler is unavailable.

The port's own copy of ``dddmr_navigation_tpu/io/native.py`` (ctypes and
numpy); ``tests/test_torch_runtime_io.py`` holds it to the original. The
library and its build script are the repo's own (``native/``), shared with
the JAX package; the fallbacks are the port's ``io/pcd.py`` and
``planning/global_/graph.py``.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LIB = None
_LIB_LOCK = threading.Lock()
_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")


def _load():
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        so = os.path.join(_NATIVE_DIR, "libdddmr_host.so")
        if not os.path.exists(so):
            try:
                subprocess.run(["sh", os.path.join(_NATIVE_DIR, "build.sh")],
                               check=True, capture_output=True, timeout=120)
            except Exception:
                _LIB = False
                return _LIB
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            _LIB = False
            return _LIB
        lib.pcd_read.restype = ctypes.c_longlong
        lib.pcd_read.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                                 ctypes.POINTER(ctypes.c_int)]
        lib.dddmr_free.argtypes = [ctypes.c_void_p]
        lib.build_knn_graph.restype = ctypes.c_int
        lib.build_knn_graph.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
            ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)]
        lib.spsc_create.restype = ctypes.c_void_p
        lib.spsc_create.argtypes = [ctypes.c_uint64]
        lib.spsc_destroy.argtypes = [ctypes.c_void_p]
        lib.spsc_push.restype = ctypes.c_int
        lib.spsc_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_uint32]
        lib.spsc_pop.restype = ctypes.c_longlong
        lib.spsc_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_uint32]
        lib.spsc_size.restype = ctypes.c_uint64
        lib.spsc_size.argtypes = [ctypes.c_void_p]
        lib.executor_create.restype = ctypes.c_void_p
        lib.executor_create.argtypes = [ctypes.c_double, _TICK_CB,
                                        ctypes.c_void_p]
        lib.executor_start.argtypes = [ctypes.c_void_p]
        lib.executor_stop.argtypes = [ctypes.c_void_p]
        lib.executor_stats.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_double)]
        lib.executor_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return bool(_load())


def read_pcd_native(path: str) -> np.ndarray:
    """C++ PCD reader; falls back to the pure-Python reader."""
    lib = _load()
    if not lib:
        from dddmr_navigation_tpu_torch.io.pcd import read_pcd
        return read_pcd(path)
    out = ctypes.POINTER(ctypes.c_float)()
    fields = ctypes.c_int()
    n = lib.pcd_read(path.encode(), ctypes.byref(out), ctypes.byref(fields))
    if n < 0:
        raise IOError(f"native PCD read failed: {path}")
    arr = np.ctypeslib.as_array(out, shape=(int(n), fields.value)).copy()
    lib.dddmr_free(out)
    return arr


def build_knn_graph_native(pts: np.ndarray, radius: float, k: int,
                           orphan_k: int = 8):
    """Native spatial-hash neighbor table; SciPy fallback.
    Returns (nbr_idx (G,K) int32 with -1 padding, nbr_dist (G,K) f32)."""
    pts = np.ascontiguousarray(np.asarray(pts, np.float32)[:, :3])
    g = len(pts)
    lib = _load()
    if not lib:
        from dddmr_navigation_tpu_torch.planning.global_.graph import (
            build_ground_graph)
        gr = build_ground_graph(pts, radius=radius, k_max=k,
                                orphan_k=orphan_k)
        return np.asarray(gr.nbr_idx), np.asarray(gr.nbr_dist)
    nbr_idx = np.full((g, k), -1, np.int32)
    nbr_dist = np.zeros((g, k), np.float32)
    rc = lib.build_knn_graph(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), g,
        ctypes.c_float(radius), k, orphan_k,
        nbr_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        nbr_dist.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError("build_knn_graph failed")
    return nbr_idx, nbr_dist


class SensorRing:
    """Lock-free SPSC byte ring for sensor ingestion (native), with a
    threading.deque fallback. Messages are numpy arrays; shape/dtype
    travel with the payload via a tiny header."""

    def __init__(self, capacity_bytes: int = 1 << 22):
        lib = _load()
        self._lib = lib if lib else None
        if self._lib:
            self._ring = lib.spsc_create(capacity_bytes)
            if not self._ring:
                raise MemoryError("spsc_create failed")
        else:
            import collections
            self._q = collections.deque(maxlen=1024)

    def push(self, arr: np.ndarray) -> bool:
        arr = np.ascontiguousarray(arr)
        if self._lib:
            header = repr((arr.dtype.str, arr.shape)).encode()
            msg = len(header).to_bytes(2, "little") + header + arr.tobytes()
            return bool(self._lib.spsc_push(self._ring, msg, len(msg)))
        self._q.append(arr)
        return True

    def pop(self, max_bytes: int = 1 << 22):
        if self._lib:
            buf = ctypes.create_string_buffer(max_bytes)
            n = self._lib.spsc_pop(self._ring, buf, max_bytes)
            if n <= 0:
                return None
            raw = buf.raw[:n]
            hlen = int.from_bytes(raw[:2], "little")
            import ast
            dtype_str, shape = ast.literal_eval(raw[2:2 + hlen].decode())
            return np.frombuffer(raw[2 + hlen:],
                                 dtype=np.dtype(dtype_str)).reshape(shape)
        try:
            return self._q.popleft()
        except IndexError:
            return None

    def __del__(self):
        lib = getattr(self, "_lib", None)
        ring = getattr(self, "_ring", None)
        if lib and ring:
            lib.spsc_destroy(ring)


# ---------------------------------------------------------------------------
# native realtime executor (rclcpp timer / MultiThreadedExecutor role)
# ---------------------------------------------------------------------------

_TICK_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_longlong)


class RealtimeExecutor:
    """Drift-free periodic tick loop in a native thread with native
    deadline accounting (`perception_3d_ros.cpp:220-249` /
    `p2p_move_base.cpp:204-257` semantics: fixed frequency, warn-on-
    overrun; overruns skip periods rather than bursting catch-up ticks).

    The Python callback runs under the GIL (ctypes acquires it); PyTorch
    launches inside the callback release the GIL, so device work
    overlaps the pacing thread. Stats (`ticks, misses, mean/p50/p99/max
    callback ms`) are computed natively."""

    def __init__(self, frequency_hz: float, callback):
        lib = _load()
        if not lib:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._exc = None

        def _trampoline(_user, tick_index):
            try:
                callback(int(tick_index))
            except Exception:   # never let an exception cross into C++
                import traceback
                self._exc = traceback.format_exc()

        self._cb = _TICK_CB(_trampoline)    # keep a reference alive
        self._h = lib.executor_create(ctypes.c_double(frequency_hz),
                                      self._cb, None)

    def start(self):
        self._lib.executor_start(self._h)

    def stop(self):
        self._lib.executor_stop(self._h)

    def stats(self) -> dict:
        out = (ctypes.c_double * 6)()
        self._lib.executor_stats(self._h, out)
        return {"ticks": int(out[0]), "deadline_misses": int(out[1]),
                "mean_ms": out[2], "p50_ms": out[3], "p99_ms": out[4],
                "max_ms": out[5], "error": self._exc}

    def close(self):
        if self._h is not None:
            self._lib.executor_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
