"""How often global localization from a random start ends within the JAX
package's test bound (1.0 m) in the box world of
``entry.global_localization_scenario()``, for the JAX package (keys
``PRNGKey(0..n-1)``) and for the port on the CPU (``torch.Generator``
seeds ``0..n-1``). Each run is ticked until it is fixed; the error is the
xy distance of the estimate to the truth at that tick.

    JAX_PLATFORMS=cpu python tools/globalloc_success_rate.py [n] [port] [jax]

(~2 minutes a JAX key and ~5 s a port seed on a 2-core CPU.)
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import numpy as np
    import torch
    from dddmr_navigation_tpu_torch import entry
    from dddmr_navigation_tpu_torch.state_estimation.likelihood import (
        build_submap_context)

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    which = sys.argv[2:] or ["port", "jax"]
    sc = entry.global_localization_scenario()
    if "port" in which:
        ctx = build_submap_context(sc.map_pts, sc.ground_pts, sc.cfg,
                                   res=sc.res, device="cpu")
        errs = []
        for seed in range(n):
            gl = entry.make_global_localization(
                sc, torch.Generator().manual_seed(seed), ctx=ctx,
                device="cpu")
            chain = entry.run_global_localization(sc, gl)
            pos, _ = entry.globalloc_pose(len(chain.n))
            errs.append(float(np.linalg.norm(
                chain.pose_pos[-1][0, :2].numpy() - pos[:2])))
            print(f"port seed {seed}: fixed {gl.fixed} at tick "
                  f"{len(chain.n)}, error {errs[-1]:.3f} m", flush=True)
        print(f"port: {sum(e < 1.0 for e in errs)} of {n} within 1.0 m",
              flush=True)
    if "jax" in which:
        from tools.make_globalloc_golden import jax_global_chain
        errs = []
        for key in range(n):
            t0 = time.time()
            _, _, recs = jax_global_chain(sc, key_seed=key)
            r = recs[-1]
            errs.append(float(np.linalg.norm(r["pose_pos"][:2]
                                             - r["true_pos"][:2])))
            print(f"jax key {key}: fixed {bool(r['fixed'])} at tick "
                  f"{len(recs)}, error {errs[-1]:.3f} m "
                  f"({time.time() - t0:.0f} s)", flush=True)
        print(f"jax: {sum(e < 1.0 for e in errs)} of {n} within 1.0 m",
              flush=True)


if __name__ == "__main__":
    main()
