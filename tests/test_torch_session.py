"""DeviceSolver in the port: twins of tests/test_session.py, on the CPU
(``device="cpu"``), plus equality with the JAX package's session."""

import numpy as np
import pytest
import torch

from slurm_bridge_tpu.solver.session import DeviceSolver as JDeviceSolver
from slurm_bridge_tpu_torch.solver import AuctionConfig, auction_place
from slurm_bridge_tpu_torch.solver.convert import config_from
from slurm_bridge_tpu_torch.solver.session import DeviceSolver
from slurm_bridge_tpu_torch.solver.snapshot import JobBatch, random_scenario
from tests.test_solver import _check_feasible

CFG = AuctionConfig(rounds=6)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in parallel workers, and torch
    on every core in each starves the timing-sensitive tests beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_matches_auction_place_and_jax():
    snap, batch = random_scenario(64, 300, seed=1, load=0.7, gang_fraction=0.1)
    a = auction_place(snap, batch, CFG, device="cpu")
    s = DeviceSolver(snap, CFG, device="cpu").solve(batch)
    np.testing.assert_array_equal(a.node_of, s.node_of)
    np.testing.assert_allclose(a.free_after, s.free_after, atol=1e-3)
    from slurm_bridge_tpu.solver.auction import AuctionConfig as JConfig

    j = JDeviceSolver(snap, JConfig(rounds=6)).solve(batch)
    assert config_from(JConfig(rounds=6)) == CFG
    np.testing.assert_array_equal(j.node_of, s.node_of)


def test_async_overlap():
    snap, b1 = random_scenario(64, 200, seed=2, load=0.5)
    _, b2 = random_scenario(64, 200, seed=3, load=0.5)
    solver = DeviceSolver(snap, CFG, device="cpu")
    h1 = solver.solve_async(b1)
    h2 = solver.solve_async(b2)  # dispatched before h1 is fetched
    p1, p2 = h1.result(), h2.result()
    _check_feasible(snap, b1, p1)
    _check_feasible(snap, b2, p2)


def test_incumbent_and_snapshot_update():
    snap, batch = random_scenario(32, 100, seed=4, load=0.6)
    solver = DeviceSolver(snap, CFG, device="cpu")
    base = solver.solve(batch)
    inc = np.where(base.placed, base.node_of, -1).astype(np.int32)
    again = solver.solve(batch, incumbent=inc)
    moved = (inc >= 0) & again.placed & (again.node_of != inc)
    assert not moved.any()
    snap2, batch2 = random_scenario(16, 50, seed=5, load=0.5)
    solver.update_snapshot(snap2)
    _check_feasible(snap2, batch2, solver.solve(batch2))


def test_drained_node_restages_in_place():
    """A caller zeroing a node's free row in place (a drain) must reach
    the staged tensors on the next update_snapshot."""
    snap, batch = random_scenario(32, 150, seed=8, load=0.6)
    solver = DeviceSolver(snap, CFG, device="cpu")
    first = solver.solve(batch)
    busiest = int(np.bincount(first.node_of[first.placed]).argmax())
    snap.free[busiest] = 0.0
    solver.update_snapshot(snap)
    after = solver.solve(batch)
    assert not (after.node_of == busiest).any()
    _check_feasible(snap, batch, after)


def test_empty_batch():
    snap, _ = random_scenario(8, 10, seed=6)
    empty = JobBatch(
        demand=np.zeros((0, 3), np.float32),
        partition_of=np.zeros(0, np.int32),
        req_features=np.zeros(0, np.uint32),
        priority=np.zeros(0, np.float32),
        gang_id=np.zeros(0, np.int32),
        job_of=np.zeros(0, np.int32),
    )
    p = DeviceSolver(snap, CFG, device="cpu").solve(empty)
    assert p.node_of.size == 0
    np.testing.assert_array_equal(p.free_after, snap.free)


def test_update_snapshot_preserves_pools_when_only_free_changes():
    snap, batch = random_scenario(64, 200, seed=4, gpu_fraction=0.2)
    solver = DeviceSolver(snap, AuctionConfig(rounds=4, candidates=8), device="cpu")
    solver.solve(batch)  # builds pools lazily
    pools = solver._pools
    assert pools is not None
    snap2 = random_scenario(64, 200, seed=4, gpu_fraction=0.2)[0]
    snap2.free = snap2.free * 0.5  # capacity churn only
    solver.update_snapshot(snap2)
    assert solver._pools is pools
    snap3 = random_scenario(64, 200, seed=5, gpu_fraction=0.2)[0]
    snap3.partition_of = (snap3.partition_of + 1) % 4  # inventory changed
    solver.update_snapshot(snap3)
    assert solver._pools is None
