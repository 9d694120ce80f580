"""On the card: a short run of each cell through the command the driver
runs, correct and with its metrics; and the bfloat16 control not correct.
Run there with ``python -m pytest bridgebench/tests -m cuda -q``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = ["slurm10k_gres.churn", "slurm10k_gres.standing"]


def _run(cell: str, *extra: str) -> dict:
    out = subprocess.run(
        [sys.executable, "bridgebench/run.py", "--workload", cell, "--seed", "2147483900",
         "--seconds", "3", *extra],
        capture_output=True, text=True, cwd=ROOT, timeout=900,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cuda, cell):
    res = _run(cell, "--trace", "0")
    assert res["correct"], res["checks"]
    assert "setup_s" in res["metrics"] and res["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_control_is_not_correct_on_the_card(cuda):
    res = _run("slurm10k_gres.churn", "--trace", "0", "--control", "bfloat16")
    assert not res["correct"]
    assert res["checks"]["placement_mismatch"]["value"] > 0
