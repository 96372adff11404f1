"""Builds the port's CUDA kernels and loads them.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one nvcc
per source, in parallel) and linked into one shared library with a plain C
interface, at first use, and loaded with
``ctypes``. The library lands in ``_build/`` beside this package, under a
name keyed by a hash of the sources and flags, so an edited source builds
anew and an unchanged one is loaded as it is. A failed build raises with
nvcc's output; nothing falls back to another implementation.

This is the counterpart of ``dddmr_navigation_tpu/ops/backend.py``: where
the JAX package probes whether Mosaic compiles, the port builds its own
library and raises if it cannot.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# --fmad=false keeps every multiply and add separately rounded, as the
# plain PyTorch versions round them, so compares and minima agree bit for
# bit. No --use_fast_math: sqrtf must stay correctly rounded.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_VOID_P, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the library's entry points (see csrc/*.cu).
SIGNATURES = {
    "swept_box_hits_launch": (
        [_VOID_P] * 5 + [_INT] * 4 + [_FLOAT] * 3 + [_VOID_P, _VOID_P]),
    "masked_min_distance_launch": (
        [_VOID_P] * 4 + [_INT] * 3 + [_VOID_P, _VOID_P]),
    "walk_table_launch": [_VOID_P] * 7 + [_INT] * 3 + [_VOID_P] * 5,
}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then PyTorch's idea of CUDA_HOME, then
    /usr/local/cuda/bin."""
    homes = [os.environ.get("CUDA_HOME")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME
        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.is_file():
        return str(fallback)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libdddmr_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the library if it is not built yet: one nvcc per source, all
    started together, then one link. Returns its path and the compiler's
    report (ptxas register and shared-memory use), empty when the library
    was already there."""
    lib = library_path()
    if lib.is_file():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = []
        for src in sources():
            obj = Path(tmpdir) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        report = [proc.communicate()[0] for _, _, proc in jobs]
        for (cmd, _, proc), out in zip(jobs, report):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{out}")
        # Link into a temporary name and rename, so a reader in another
        # process never loads a half-written library.
        tmp = Path(tmpdir) / lib.name
        cmd = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, lib)
    return lib, "".join(report)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
