"""The mirror's classification part: ``mirror_classify_ms`` reads the
providers' ``vnode.classify`` time from a small CPU churn run, and nothing
from ticks that carry no such part."""

from __future__ import annotations

from bblib import cells
from bblib.loop import Run
from conftest import ROOT, run_tiny, tiny_cell


def test_churn_lists_mirror_classify_ms():
    listed = {m["name"] for m in cells.load(ROOT, "slurm10k_gres.churn").per_layer}
    assert "mirror_classify_ms" in listed


def test_mirror_classify_ms_reads_the_part():
    result, _early, _checks, run = run_tiny(tiny_cell("slurm10k_gres", "churn", 400))
    assert result["correct"]
    value = cells.reader("mirror_classify_ms")(run)
    assert isinstance(value, float)
    assert 0.0 < value <= cells.reader("mirror_ms")(run)


def test_mirror_classify_ms_reads_nothing_without_the_part():
    tick = {"tick": 10.0, "gc": 1.0, "mirror": 4.0, "mirror.sweep": 1.0}
    run = Run(window_kind="all", ticks=[tick] * 3)
    assert cells.reader("mirror_classify_ms")(run) is None
