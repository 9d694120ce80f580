"""A cell found by its name: ``BENCHMARK.json`` names the cell's
configuration (its file) and traffic; the traffic mix is
``traffic/<name>.json`` and each metric's reader ``metrics/<name>.py``
beside this package. A cell, configuration, traffic mix or metric is added
with new files and entries alone."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    #: metric entries of BENCHMARK.json this cell reports, by kind
    end_to_end: list[dict] = field(default_factory=list)
    per_layer: list[dict] = field(default_factory=list)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root: str, workload: str, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, workload)],
    )


def reader(name: str, bench_dir: str = BENCH_DIR):
    """The ``read(run)`` function of metric ``name``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
