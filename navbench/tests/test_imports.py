"""What the benchmark loads: no JAX, no JAX package (top-level names
compared whole, since the program's name begins with the JAX package's),
and a reference that loads nothing of the program."""
from __future__ import annotations

import os
import subprocess
import sys

from navbench.spec import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "dddmr_navigation_tpu")


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONPATH": ROOT})
    return set(out.stdout.split())


def test_the_harness_loads_no_jax_and_no_jax_package():
    tops = _loaded(
        "import glob, importlib, os\n"
        "import navbench.run, navbench.calibrate, navbench.readers\n"
        "for f in glob.glob('navbench/systems/*.py'):\n"
        "    importlib.import_module('navbench.systems.' + os.path.basename"
        "(f)[:-3])\n"
        "from navbench.spec import load_benchmark, load_generator, "
        "load_reader, load_traffic\n"
        "[load_reader(m['name']) for m in load_benchmark()['per_layer']]\n"
        "[load_generator(load_traffic(w['traffic'])['generator'])\n"
        " for w in load_benchmark()['workloads']]\n"
        "import dddmr_navigation_tpu_torch.parallel.fleet\n"
        "import dddmr_navigation_tpu_torch.control.fused\n")
    assert not tops & set(FORBIDDEN), tops & set(FORBIDDEN)
    assert "dddmr_navigation_tpu_torch" in tops


def test_the_reference_loads_nothing_of_the_program():
    tops = _loaded(
        "import glob, importlib\n"
        "for f in sorted(glob.glob('navbench/reference/**/*.py', "
        "recursive=True)):\n"
        "    m = f[:-3].replace('/', '.')\n"
        "    importlib.import_module(m[:-9] if m.endswith('__init__') "
        "else m)\n")
    assert not tops & set(FORBIDDEN + ("dddmr_navigation_tpu_torch",))


def test_forbidden_names_are_compared_whole():
    from navbench.run import forbidden_modules
    import dddmr_navigation_tpu_torch  # noqa: F401
    assert "dddmr_navigation_tpu_torch" not in forbidden_modules()
