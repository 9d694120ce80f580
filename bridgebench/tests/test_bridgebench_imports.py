"""Nothing the benchmark runs loads JAX, the JAX package or its benchmarks
(top-level module names compared whole: the port's name begins with the
JAX package's), and the reference loads nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "slurm_bridge_tpu", "bench", "benchmarks"}


def _loaded(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=ROOT,
        env={"PYTHONPATH": f"{BENCH}:{ROOT}", "PATH": "/usr/bin:/bin"},
    ).stdout.strip().splitlines()[-1]
    return set(json.loads(out))


def test_reference_loads_nothing_of_the_program():
    top = _loaded("import bblib.reference, bblib.gen, bblib.roofline, bblib.readers")
    assert not top & FORBIDDEN
    assert "slurm_bridge_tpu_torch" not in top


def test_a_run_loads_no_jax():
    code = (
        "import sys, time; sys.path.insert(0, 'bridgebench/tests')\n"
        "from conftest import STREAM, prod_config, tiny_cell, run_tiny\n"
        "from bblib import loop\n"
        "res = run_tiny(tiny_cell(prod_config(), STREAM, 800), seconds=1.0)\n"
        "assert res[0]['correct']\n"
        "assert not loop.forbidden_modules(), loop.forbidden_modules()\n"
    )
    top = _loaded(code)
    assert "slurm_bridge_tpu_torch" in top
    assert not top & FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from bblib import loop

    monkeypatch.setitem(sys.modules, "slurm_bridge_tpu_torch_like", sys)
    assert "slurm_bridge_tpu_torch_like" not in loop.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in loop.forbidden_modules()
