"""The check that decides ``correct``, driven on the CPU at a tiny size:
sound runs pass; the bfloat16 control and each fault the cells can have
(a solve that leaves its state unchanged, half the batch left out, an
answer altered where it is produced) read not correct."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import STREAM, prod_config, run_tiny, tiny_cell

CELLS = [("slurm10k_gres", "churn", 400), ("prod", STREAM, 800),
         ("slurm10k_gres", "standing", 400)]


def _cell(config, traffic, nodes):
    return tiny_cell(prod_config() if config == "prod" else config, traffic, nodes)


@pytest.mark.parametrize("config,traffic,nodes", CELLS)
def test_sound_run_is_correct(config, traffic, nodes):
    result, early, checks, run = run_tiny(_cell(config, traffic, nodes))
    assert result["correct"], checks.line()
    assert checks.items["placement_mismatch"]["value"] == 0
    assert checks.items["solves_checked"]["value"] >= 1
    assert early["window"]["ticks"] == len(run.ticks) == 4


@pytest.mark.parametrize("config,traffic,nodes", CELLS)
def test_bfloat16_control_is_not_correct(config, traffic, nodes):
    result, _early, checks, _run = run_tiny(_cell(config, traffic, nodes), dtype="bfloat16")
    assert not result["correct"]
    assert checks.items["placement_mismatch"]["value"] > 0


def _unchanged(monkeypatch):
    from slurm_bridge_tpu_torch.solver.session import DeviceSolver
    from slurm_bridge_tpu_torch.solver.snapshot import Placement

    def solve(self, batch, incumbent=None):
        return Placement(node_of=np.full(batch.num_shards, -1, np.int32),
                         placed=np.zeros(batch.num_shards, bool),
                         free_after=self.snapshot.free.copy())

    monkeypatch.setattr(DeviceSolver, "solve", solve)


def _half_batch(monkeypatch):
    from slurm_bridge_tpu_torch.bridge.scheduler import PlacementScheduler

    orig = PlacementScheduler._pending_set
    monkeypatch.setattr(PlacementScheduler, "_pending_set", lambda self: orig(self)[::2])


def _altered(monkeypatch):
    from slurm_bridge_tpu_torch.solver.session import DeviceSolver

    orig = DeviceSolver.solve

    def solve(self, batch, incumbent=None):
        pl = orig(self, batch, incumbent)
        placed = np.nonzero(pl.placed & (batch.job_of >= 0))[0]
        if placed.size:
            r = placed[len(placed) // 2]
            same = np.nonzero(self.snapshot.partition_of == self.snapshot.partition_of[pl.node_of[r]])[0]
            pl.node_of[r] = same[(np.searchsorted(same, pl.node_of[r]) + 1) % same.size]
        return pl

    monkeypatch.setattr(DeviceSolver, "solve", solve)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, _early, checks, _run = run_tiny(tiny_cell("slurm10k_gres", "churn", 400))
    assert not result["correct"], checks.line()


@pytest.mark.parametrize("auction", [{"affinity_weight": 0.05}, {"gang_first": True},
                                     {"candidates": 64}])
def test_judge_refuses_what_the_reference_lacks(auction):
    from bblib import judge

    config = {"bridge": {"auction": {"rounds": 8, **auction}, "policy": False,
                         "admission": False}}
    with pytest.raises(ValueError):
        judge.judge(None, None, None, None, config, 0, device="cpu")
