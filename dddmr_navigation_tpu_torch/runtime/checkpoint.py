"""Deterministic per-tick state checkpointing (counterpart of
``dddmr_navigation_tpu/runtime/checkpoint.py``; SURVEY.md §5's spec for
the compute level the reference lacks: its checkpointing is map-artifact
only, pcdSaver pose graphs, `mapOptimization.h:91`).

Every dynamic state of the port is a tree of tensors — NamedTuples
(``MarkingState``, ``MCLState``, ``FSMState``, ...), dicts, lists and
tuples — so a checkpoint is one :func:`save_pytree` per tick boundary, in
the JAX package's file format: ``leaf_i`` arrays in an .npz plus a
``.meta.json`` sidecar, the leaves in ``jax.tree_util``'s order (NamedTuple
fields in order, dict keys sorted, ``None`` no leaf). A file either package
writes restores in the other. :func:`restore_pytree` rebuilds against a
structural template and puts each tensor on its template leaf's device,
with its dtype.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch


def _children(tree):
    """(kind, keys, children) of an inner node, or None for a leaf."""
    if tree is None:
        return "none", (), []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return f"namedtuple[{type(tree).__name__}]", tree._fields, list(tree)
    if isinstance(tree, (list, tuple)):
        return type(tree).__name__, (), list(tree)
    if isinstance(tree, dict):
        keys = sorted(tree)
        return "dict", tuple(keys), [tree[k] for k in keys]
    return None


def tree_flatten(tree):
    """(leaves, structure string) in ``jax.tree_util``'s order."""
    leaves = []

    def walk(node):
        c = _children(node)
        if c is None:
            leaves.append(node)
            return "*"
        kind, keys, kids = c
        inner = ", ".join(walk(k) for k in kids)
        return f"{kind}{list(keys) if keys else ''}({inner})"

    return leaves, walk(tree)


def tree_unflatten(template, leaves):
    """``template``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(node):
        c = _children(node)
        if c is None:
            return next(it)
        kind, keys, kids = c
        new = [build(k) for k in kids]
        if kind == "none":
            return None
        if kind == "dict":
            return dict(zip(keys, new))
        if kind.startswith("namedtuple"):
            return type(node)(*new)
        return type(node)(new)

    return build(template)


def _host(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_pytree(path: str, tree) -> None:
    """Serialize a tree of tensors/arrays/scalars to ``path``.npz (+
    ``.meta.json``)."""
    leaves, structure = tree_flatten(tree)
    arrays = {f"leaf_{i}": _host(x) for i, x in enumerate(leaves)}
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **arrays)
    meta = {"num_leaves": len(leaves), "treedef": structure}
    with open(_meta_path(path), "w") as f:
        json.dump(meta, f)


def restore_pytree(path: str, template):
    """Restore into the structure of ``template`` (shapes must match): a
    tensor leaf comes back as a tensor of its template's dtype on its
    template's device; a numpy leaf as an array; a scalar as its type."""
    npz = np.load(path if path.endswith(".npz") else path + ".npz")
    leaves, _ = tree_flatten(template)
    assert len(npz.files) == len(leaves), (
        f"checkpoint has {len(npz.files)} leaves, template {len(leaves)}")
    new = []
    for i, t in enumerate(leaves):
        x = npz[f"leaf_{i}"]
        if torch.is_tensor(t):
            new.append(torch.as_tensor(x).to(device=t.device, dtype=t.dtype))
        elif isinstance(t, np.ndarray):
            new.append(x.astype(t.dtype))
        else:
            new.append(type(t)(x))
    return tree_unflatten(template, new)


def _meta_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".meta.json"


class CheckpointManager:
    """Rotating checkpoint slots + resume-latest."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _slot(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}")

    def _steps(self) -> list:
        return sorted(
            int(f[5:13]) for f in os.listdir(self.directory)
            if f.startswith("ckpt_") and f.endswith(".npz"))

    def save(self, step: int, tree) -> str:
        p = self._slot(step)
        save_pytree(p, tree)
        self._gc()
        return p + ".npz"

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, template):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, restore_pytree(self._slot(step), template)

    def _gc(self):
        for s in self._steps()[:-self.keep]:
            for suffix in (".npz", ".meta.json"):
                try:
                    os.remove(self._slot(s) + suffix)
                except OSError:
                    pass
