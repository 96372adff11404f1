"""dddmr_navigation_tpu_torch — the local-planner fleet tick and the fused
perception → global replan → local tick of ``dddmr_navigation_tpu``
ported to PyTorch, with hand-written CUDA kernels for an NVIDIA H100
(``sm_90a``).

The JAX package stays the reference. The port mirrors its module paths
(``geometry/``, ``ops/``, ``perception/``, ``planning/local/``,
``planning/global_/``, ``control/fused.py``, ``parallel/fleet.py``),
shares its framework-free config dataclasses
(``dddmr_navigation_tpu.config``) and numpy-only modules (``shared.py``)
and never imports JAX. Every per-robot tensor has a leading robot axis B;
map tables are shared.
"""


def not_ported(name: str, what: str):
    """A stand-in for the JAX package's ``name``, not ported yet: calling
    it raises NotImplementedError naming it (ROADMAP.md, Queue 1)."""
    def fn(*args, **kwargs):
        raise NotImplementedError(f"{name} is not ported yet ({what})")
    fn.__name__ = fn.__qualname__ = name
    return fn
