"""The port's global localization against the JAX package's recorded
chain (``testdata/globalloc_golden.npz``, ``tools/make_globalloc_golden.py``)
on the CPU, at the scenario's full 2,048 seed particles: the first ticks
from JAX's seed and update draws and recorded inputs, unforced.

Tolerances: exact for particle counts, ``fix_cnt`` and the fixed flag;
estimates and particles within the fleet's rtol 2e-6 (atol 1e-6), the
map→odom LPF states within atol 2e-5 (see test_torch_localization.py).
"""
import os

import numpy as np
import torch

from dddmr_navigation_tpu_torch import entry
from dddmr_navigation_tpu_torch.interop import (
    mcl_fields, pack_ticks, port_seed_draws, port_tick_of_one, tick_of)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "dddmr_navigation_tpu_torch", "testdata",
                      "globalloc_golden.npz")
TICKS = 5
INPUT_KEYS = ("odom_prev_pos", "odom_prev_quat", "odom_pos", "odom_quat",
              "flat", "flat_m", "sharp", "sharp_m")


def test_golden_inputs_are_the_scenarios():
    """The recorded scans and odometry are the port's scenario builders'
    (the golden tool builds them from ``entry.globalloc_inputs``)."""
    g = np.load(GOLDEN)
    sc = entry.global_localization_scenario()
    for k in (0, int(g["n"].shape[0]) - 1):
        x = entry.globalloc_inputs(sc, k + 1)
        rec = tick_of(g, k)
        for name in ("odom_prev_pos", "odom_pos", "flat", "flat_m", "sharp",
                     "sharp_m"):
            np.testing.assert_array_equal(rec[name], x[name], err_msg=name)
    assert bool(g["fixed"][-1]) and not g["fixed"][:-1].any()
    assert int(g["n"][0]) == sc.num_start and int(g["size"][-1]) == 32
    # the record round-trips through pack_ticks
    recs = [tick_of(g, k) for k in range(3)]
    again = pack_ticks(recs)
    np.testing.assert_array_equal(again["res_pos"],
                                  g["res_pos"][:sum(int(n) for n in
                                                    g["n"][:3])])


def test_golden_first_ticks_replay():
    g = np.load(GOLDEN)
    sc = entry.global_localization_scenario(ticks=TICKS + 1)
    gl = entry.make_global_localization(
        sc, seed_draws=port_seed_draws(g, "cpu"), device="cpu")
    recs = [tick_of(g, k) for k in range(TICKS + 1)]

    def inputs_of(t):
        return {k: torch.as_tensor(recs[t - 1][k]) for k in INPUT_KEYS}
    start = mcl_fields(gl.state)
    for name, want in recs[0].items():
        if name.startswith("mcl_particles_pos"):
            np.testing.assert_array_equal(start[name][0], want)
    chain = entry.run_global_localization(
        sc, gl, draws_of=lambda t: port_tick_of_one(recs[t - 1], "cpu")[1],
        inputs_of=inputs_of, keep_states=True)
    assert chain.n == [int(g["n"][k]) for k in range(TICKS)]
    assert chain.fix_cnt == [int(g["fix_cnt"][k]) for k in range(TICKS)]
    assert chain.fixed == [False] * TICKS
    for k in range(TICKS):
        np.testing.assert_allclose(chain.pose_pos[k][0].numpy(),
                                   g["pose_pos"][k], rtol=2e-6, atol=1e-6)
        np.testing.assert_allclose(chain.pose_quat[k][0].numpy(),
                                   g["pose_quat"][k], rtol=2e-6, atol=1e-6)
        got = mcl_fields(chain.states[k])
        for name, want in recs[k + 1].items():
            if name.startswith("mcl_"):
                lpf = name.startswith(("mcl_f_pos", "mcl_f_ang"))
                np.testing.assert_allclose(got[name][0], want, rtol=2e-6,
                                           atol=2e-5 if lpf else 1e-6,
                                           err_msg=f"tick {k + 1} {name}")
