"""The readers of the phases' parts (the program's spans inside a phase):
numbers from a small CPU run of each cell that lists them, nothing from a
program whose ticks carry no parts, and a traced run whose idle time is
named by the program's own spans."""

from __future__ import annotations

import pytest

from bblib import cells
from bblib.loop import Run
from conftest import ROOT, run_tiny, tiny_cell

#: the parts' metrics, by the cell that lists them
PARTS = {
    "slurm10k_gres.churn": ["inventory_ms", "pending_scan_ms", "repair_ms", "host_syncs",
                            "mirror_submit_ms", "mirror_status_ms", "mirror_sweep_ms"],
    "slurm10k_gres.standing": ["prepare_ms.steady", "mirror_status_ms.steady"],
}


def test_each_cell_lists_its_parts():
    for workload, names in PARTS.items():
        listed = {m["name"] for m in cells.load(ROOT, workload).per_layer}
        assert set(names) <= listed, workload


@pytest.fixture(scope="module")
def churn():
    """A traced tiny churn run on the CPU."""
    return run_tiny(tiny_cell("slurm10k_gres", "churn", 400), traced=True)


def test_churn_parts_read_numbers(churn):
    result, _early, _checks, run = churn
    assert result["correct"]
    values = {n: cells.reader(n)(run) for n in PARTS["slurm10k_gres.churn"]}
    for name, value in values.items():
        assert isinstance(value, float) and value >= 0.0, (name, value)
    for name in ("inventory_ms", "pending_scan_ms", "host_syncs", "mirror_status_ms"):
        assert values[name] > 0.0, name
    assert values["inventory_ms"] + values["pending_scan_ms"] <= cells.reader("store_ms")(run)
    parts = values["mirror_submit_ms"] + values["mirror_status_ms"] + values["mirror_sweep_ms"]
    assert parts <= cells.reader("mirror_ms")(run)


def test_traced_idle_time_is_named_by_the_program(churn):
    """With the program's spans on the trace, time the benchmark's own
    ranges left unnamed goes to the program's spans: the harness's own
    verification, the mirror's parts, the scheduler's parts."""
    _result, _early, _checks, run = churn
    idle = dict(run.profile["idle_by_range"])
    for name in ("sim.verify", "scheduler.store.inventory", "scheduler.prepare",
                 "solve.rounds", "operator.sweep"):
        assert idle.get(name, 0.0) > 0.0, name
    assert idle.get("harness", 0.0) < 0.05 * sum(idle.values())


def test_standing_parts_read_numbers():
    result, _early, _checks, run = run_tiny(tiny_cell("slurm10k_gres", "standing", 400))
    assert result["correct"] and run.window_kind == "steady"
    for name in PARTS["slurm10k_gres.standing"]:
        value = cells.reader(name)(run)
        assert isinstance(value, float) and value >= 0.0, (name, value)
    assert cells.reader("mirror_status_ms.steady")(run) > 0.0


def test_a_program_without_parts_reads_nothing():
    run = Run(window_kind="steady", ticks=[{"tick": 10.0, "gc": 1.0, "store": 2.0}] * 3)
    for names in PARTS.values():
        for name in names:
            assert cells.reader(name)(run) is None, name
