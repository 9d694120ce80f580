"""Shared set-up for the benchmark's own tests: the benchmark folder and
the checkout root on the import path, tiny CPU cells, the card fixture."""

from __future__ import annotations

import copy
import json
import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def tiny_cell(config, traffic, nodes: int = 400, **traffic_over):
    """A cell of a configuration and a traffic mix (the real files by name,
    or dicts a test made), cut to ``nodes`` nodes with its counts scaled
    alike, a few warm ticks and a short nominal tick: what a CPU test run
    can hold."""
    from bblib import cells

    if isinstance(config, str):
        with open(os.path.join(BENCH, "configs", f"{config}.json")) as f:
            config = json.load(f)
    if isinstance(traffic, str):
        with open(os.path.join(BENCH, "traffic", f"{traffic}.json")) as f:
            traffic = json.load(f)
    cfg, tr = copy.deepcopy(config), copy.deepcopy(traffic)
    full = cfg["cluster"]["num_nodes"]
    cfg["cluster"]["num_nodes"] = nodes
    cfg["scale"] = {k: max(20, v * nodes // full) for k, v in cfg["scale"].items()}
    if "warm_ticks" in tr:
        tr["warm_ticks"] = min(tr["warm_ticks"], 4)
    tr["nominal_tick_s"] = 0.5
    tr.update(traffic_over)
    return cells.Cell(name=f"{cfg['name']}.{tr['name']}", chips=1, config=cfg, traffic=tr)


def prod_config() -> dict:
    """A configuration with the policy and the fast path on: 9,600 CPU
    nodes in 2 partitions, 15 % 4-node gangs, 30 % production jobs. No
    cell of the benchmark runs it; it keeps the reference's admission and
    policy order under test for a later cell."""
    with open(os.path.join(BENCH, "configs", "slurm10k_gres.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "slurm9600_prod"
    cfg["cluster"].update(num_nodes=9600, num_partitions=2, gpu_fraction=0.0)
    cfg["jobs"].update(gang_fraction=0.15, gpu_fraction=0.0,
                       priority_classes=[["batch", 0.7], ["production", 0.3]])
    cfg["scale"] = {"stream_jobs_per_tick": 2750}
    cfg["bridge"].update(policy=True, admission=True)
    return cfg


STREAM = {"name": "stream", "why": "a Poisson stream",
          "populations": [{"arrival": "poisson", "count": "stream_jobs_per_tick",
                           "jobs": {"duration_range": [30.0, 60.0]}}],
          "warm_ticks": 12, "window": "all", "nominal_tick_s": 2.0}


def run_tiny(cell, seed: int = 2**31 + 5, seconds: float = 2.0, **kw):
    from bblib import loop

    return loop.run_cell(cell, seed=seed, seconds=seconds, traced=kw.pop("traced", False),
                         device="cpu", t0=time.perf_counter(), **kw)


@pytest.fixture
def cuda():
    """Skips the test without a CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
