"""The port does all that the JAX package does: every public top-level
function and class of every JAX module has a counterpart of the same name
(a ``def``, a ``class`` or an assignment) in the port's module of the same
path. Both packages are parsed with ``ast``; neither is imported.

The exceptions, each with its reason, are :data:`EXCEPTIONS`; a new public
name in the JAX package fails here until the port has it or it is listed.
"""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "dddmr_navigation_tpu")
PORT_PKG = os.path.join(ROOT, "dddmr_navigation_tpu_torch")

EXCEPTIONS = {
    ("ops/backend.py", "pallas_supported"):
        "the Mosaic compile probe; the port builds its kernels with nvcc "
        "and raises on failure (ops/build.py)",
    ("ops/backend.py", "resolve_backend"):
        "the port dispatches on the tensor's device (CUDA → kernel, CPU → "
        "plain version), so there is no backend to resolve",
    ("ops/collision.py", "pl_ds"):
        "a Pallas slicing helper of the TPU kernel; the CUDA kernel indexes "
        "directly",
    ("planning/local/rollout.py", "step_quats"):
        "no caller in the JAX package",
}


def _public_defs(path):
    tree = ast.parse(open(path).read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def _defined(path):
    tree = ast.parse(open(path).read())
    out = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, ast.Assign):
            out.update(t.id for t in n.targets if isinstance(t, ast.Name))
        elif isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.add(n.target.id)
    return out


def _jax_modules():
    mods = []
    for dirpath, _, files in os.walk(JAX_PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                mods.append(os.path.relpath(os.path.join(dirpath, f),
                                            JAX_PKG).replace(os.sep, "/"))
    return sorted(mods)


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_name_has_a_counterpart(rel):
    want = _public_defs(os.path.join(JAX_PKG, rel))
    port = os.path.join(PORT_PKG, rel)
    have = _defined(port) if os.path.exists(port) else set()
    missing = sorted(n for n in want - have if (rel, n) not in EXCEPTIONS)
    assert not missing, (rel, missing)


def test_exceptions_are_still_needed():
    """Each listed exception names a JAX function the port still lacks."""
    for rel, name in EXCEPTIONS:
        assert name in _public_defs(os.path.join(JAX_PKG, rel)), (rel, name)
        port = os.path.join(PORT_PKG, rel)
        assert not (os.path.exists(port) and name in _defined(port)), (
            rel, name)
