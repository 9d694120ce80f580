"""The production-mode cell, ``slurm10k_prod.interactive``, cut to a CPU
size: a sound run is correct with fast binds and ``no_fit`` misses in its
window and its seven readers read numbers; the bfloat16 control and an
altered fast-path hint read not correct; the readers read nothing from a
program whose ticks carry no such part. On the card (``-m cuda``): a few
window ticks through the command the driver runs."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest

from bblib import cells
from bblib.loop import Run
from conftest import ROOT, run_tiny, tiny_cell

CELL = "slurm10k_prod.interactive"
READERS = ["admit_ms", "admit_p50_ms", "admit_p99_ms", "fastpath_miss_pct",
           "policy_prepare_ms", "backfill_ms", "admission_window_ms"]


def _cell():
    return tiny_cell("slurm10k_prod", "interactive", 400)


def _window(run, key: str) -> float:
    return sum(t[key] for t in run.ticks)


@pytest.fixture(scope="module")
def sound():
    return run_tiny(_cell())


def test_the_cell_lists_the_new_metrics():
    cell = cells.load(ROOT, CELL)
    assert [m["name"] for m in cell.end_to_end] == ["tick_ms", "setup_s"]
    assert READERS == [m["name"] for m in cell.per_layer]
    assert cell.config["bridge"]["policy"] and cell.config["bridge"]["admission"]


def test_sound_run_is_correct_with_binds_and_misses(sound):
    result, early, checks, run = sound
    assert result["correct"], checks.line()
    assert checks.items["fast_path_mismatch"]["value"] == 0
    assert checks.items["placement_mismatch"]["value"] == 0
    assert early["window"]["ticks"] == len(run.ticks) == 4
    assert _window(run, "arrive.admit.binds") > 0
    assert _window(run, "arrive.admit.miss_no_fit") > 0


def test_readers_read_the_window(sound):
    _result, _early, _checks, run = sound
    values = {n: cells.reader(n)(run) for n in READERS}
    for name, value in values.items():
        assert isinstance(value, float) and value >= 0.0, (name, value)
    assert 0.0 < values["fastpath_miss_pct"] < 100.0
    assert 0.0 < values["admit_p50_ms"] <= values["admit_p99_ms"]
    walls = [w for t in run.ticks for w in t["arrive.admit.walls"]]
    assert len(walls) == _window(run, "arrive.admit.binds")
    assert values["admit_p99_ms"] == pytest.approx(float(np.percentile(walls, 99)))
    misses = _window(run, "arrive.admit.attempts") - _window(run, "arrive.admit.binds")
    assert values["fastpath_miss_pct"] == pytest.approx(
        100.0 * misses / _window(run, "arrive.admit.attempts"))
    # each part inside its phase
    n = len(run.ticks)
    assert values["admit_ms"] <= cells.reader("arrive_ms")(run)
    assert values["policy_prepare_ms"] <= _window(run, "prepare") / n
    assert values["backfill_ms"] <= cells.reader("other_ms")(run)
    assert values["admission_window_ms"] <= cells.reader("bind_ms")(run)


def test_bfloat16_control_is_not_correct():
    result, _early, checks, _run = run_tiny(_cell(), dtype="bfloat16")
    assert not result["correct"]
    assert checks.items["placement_mismatch"]["value"] > 0


def test_altered_fast_path_hint_is_not_correct(monkeypatch):
    """Each fast bind's first node moved to the next node of its
    partition (the residual debited where the guard chose): the reference
    binds elsewhere."""
    from slurm_bridge_tpu_torch.admission.fastpath import FastPathAdmitter

    orig = FastPathAdmitter.admit

    def admit(self, demand, rank):
        names, reason, token = orig(self, demand, rank)
        if names:
            snap = self.view.snapshot
            pos = list(snap.node_names).index(names[0])
            same = np.nonzero(snap.partition_of == snap.partition_of[pos])[0]
            moved = same[(np.searchsorted(same, pos) + 1) % same.size]
            names = (snap.node_names[int(moved)],) + tuple(names[1:])
        return names, reason, token

    monkeypatch.setattr(FastPathAdmitter, "admit", admit)
    result, _early, checks, _run = run_tiny(_cell())
    assert not result["correct"]
    assert checks.items["fast_path_mismatch"]["value"] > 0


def test_a_program_without_the_parts_reads_nothing():
    run = Run(window_kind="all", ticks=[{"tick": 10.0, "gc": 1.0, "arrive": 2.0}] * 3)
    for name in READERS:
        assert cells.reader(name)(run) is None, name


@pytest.mark.cuda
def test_cell_runs_correct_on_the_card(cuda):
    out = subprocess.run(
        [sys.executable, "bridgebench/run.py", "--workload", CELL, "--seed", "2147483900",
         "--seconds", "7", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, timeout=900,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["checks"]["fast_path_mismatch"]["value"] == 0
    assert set(READERS) <= set(res["metrics"]) and res["device"]["platform"] == "gpu"
