"""A later cell, configuration, traffic mix and metric are new files and
entries alone: a copy of the benchmark gains all four from files only this
test writes, and runs the new cell with the harness unedited."""

from __future__ import annotations

import json
import os
import shutil
import time

from conftest import BENCH, ROOT


def test_new_files_make_a_new_cell(tmp_path):
    from bblib import cells, loop

    root = tmp_path / "checkout"
    bench_dir = root / "bridgebench"
    shutil.copytree(BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(BENCH, "configs", "slurm10k_gres.json")) as f:
        cfg = json.load(f)
    cfg.update(name="slurm300_tiny")
    cfg["cluster"]["num_nodes"] = 300
    cfg["scale"] = {"stream_jobs_per_tick": 40, "standing_jobs": 600}
    (bench_dir / "configs" / "slurm300_tiny.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "trickle.json").write_text(json.dumps({
        "name": "trickle", "why": "a slow stream",
        "populations": [{"arrival": "poisson", "count": "stream_jobs_per_tick",
                         "jobs": {"duration_range": [10.0, 20.0]}}],
        "warm_ticks": 3, "window": "all", "nominal_tick_s": 0.5,
    }))
    (bench_dir / "metrics" / "ticks_in_window.py").write_text(
        "def read(run):\n    return float(len(run.ticks))\n")
    bench["configs"].append({"name": "slurm300_tiny", "source": "a test", "why": "a test",
                             "file": "bridgebench/configs/slurm300_tiny.json", "reduced": []})
    bench["workloads"].append({"name": "slurm300_tiny.trickle", "config": "slurm300_tiny",
                               "traffic": "trickle", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "ticks_in_window", "unit": "ticks", "better": "higher",
                               "source": "host_clock", "layer": "harness", "moves": "tick_ms",
                               "workloads": ["slurm300_tiny.trickle"]})
    bench["end_to_end"][0]["workloads"].append("slurm300_tiny.trickle")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load(str(root), "slurm300_tiny.trickle", bench_dir=str(bench_dir))
    assert cell.traffic["name"] == "trickle" and cell.config["name"] == "slurm300_tiny"
    result, _early, checks, run = loop.run_cell(cell, seed=7, seconds=1.0, traced=False,
                                                device="cpu", t0=time.perf_counter())
    assert result["correct"], checks.line()
    names = [m["name"] for m in cell.per_layer]
    assert "ticks_in_window" in names
    read = cells.reader("ticks_in_window", bench_dir=str(bench_dir))
    assert read(run) == len(run.ticks) == 2
