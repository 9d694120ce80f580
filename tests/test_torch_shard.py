"""The port's shard executor where the port differs from the JAX package:
each shard's auction runs on the executor's device, a big shard takes the
multi-device sweep when the process solves on two or more devices, an
attached fleet gets each keyed shard's solve (and a shard it declines is
solved inline), and a failing device solve — the sweep's too — surfaces
out of the tick instead of turning into a CPU solve. Where the two packages do the same, they give the same
placements: the executor's auction route against the JAX package's on the
same inventory, no tolerance."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
import slurm_bridge_tpu.core.types as jax_types
import slurm_bridge_tpu.shard as jax_shard
import slurm_bridge_tpu.solver as jax_solver
import slurm_bridge_tpu_torch.core.types as port_types
import slurm_bridge_tpu_torch.parallel.mesh as port_mesh
import slurm_bridge_tpu_torch.shard as port_shard
import slurm_bridge_tpu_torch.solver as port_solver
import slurm_bridge_tpu_torch.solver.session as port_session
import slurm_bridge_tpu_torch.solver.sharded as port_sharded
from slurm_bridge_tpu_torch.bridge.scheduler import PlacementScheduler
from slurm_bridge_tpu_torch.parallel.backend import BackendUnavailable
from slurm_bridge_tpu_torch.solver.snapshot import random_inventory


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class _Pod:
    """What the executor reads of a pending pod: a key."""

    def __init__(self, uid: str):
        self.uid = uid


def _world(types, n=96, parts=3, jobs=90, seed=3):
    """Three partitions, every eighth node with GPUs, singles and gangs."""
    rng = np.random.default_rng(seed)
    nodes = [
        types.NodeInfo(name=f"n{i:03d}", cpus=16, memory_mb=32768,
                       gpus=4 if i % 8 == 0 else 0,
                       features=("gpu_type0",) if i % 8 == 0 else ())
        for i in range(n)
    ]
    partitions = [
        types.PartitionInfo(name=f"part{p}",
                            nodes=tuple(nd.name for i, nd in enumerate(nodes) if i % parts == p))
        for p in range(parts)
    ]
    demands = [
        types.JobDemand(partition=f"part{j % parts}", cpus_per_task=int(rng.integers(1, 9)),
                        ntasks=1, nodes=int(rng.choice([1, 1, 1, 2, 4])),
                        mem_per_cpu_mb=1024, priority=int(rng.integers(0, 100)))
        for j in range(jobs)
    ]
    return partitions, nodes, demands, [_Pod(f"job{j:04d}") for j in range(jobs)]


def _solve(executor, types):
    partitions, nodes, demands, pods = _world(types)
    return executor.solve(partitions, nodes, demands, pods, len(pods),
                          demand_key=lambda p: p.uid)


CONFIG = dict(max_nodes_per_shard=16, workers=2, device_solve=False)


def test_shard_auction_on_the_cpu_equals_the_jax_package():
    ref = jax_shard.ShardExecutor(
        jax_shard.ShardConfig(**CONFIG), backend="auction",
        auction_config=jax_solver.AuctionConfig(rounds=8, candidates=0), bucket=64,
    )
    port = port_shard.ShardExecutor(
        port_shard.ShardConfig(**CONFIG), backend="auction",
        auction_config=port_solver.AuctionConfig(rounds=8, candidates=0), bucket=64,
        device="cpu",
    )
    want, got = _solve(ref, jax_types), _solve(port, port_types)
    assert got == want and got[0]
    assert port.stats()["shard_count"] == ref.stats()["shard_count"] >= 2
    assert port.last_routes == ref.last_routes == {"auction": port.last_shards_used}


def test_shard_auction_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.delenv("SBT_BACKEND", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    ex = port_shard.ShardExecutor(port_shard.ShardConfig(**CONFIG), backend="auction")
    with pytest.raises(BackendUnavailable):
        _solve(ex, port_types)


def test_forced_device_solve_with_one_device_stays_on_the_single_device_auction():
    """``device_solve=True`` asks for the multi-device sweep; with fewer
    than two devices each shard takes the single-device auction, as the
    JAX package does on one device."""
    ex = port_shard.ShardExecutor(
        port_shard.ShardConfig(max_nodes_per_shard=16, workers=2, device_solve=True),
        backend="auto", auction_config=port_solver.AuctionConfig(rounds=4), bucket=64,
        device="cpu",
    )
    by_job, _ = _solve(ex, port_types)
    assert by_job
    assert "auction-sharded" not in ex.last_routes


def _two_devices(monkeypatch):
    cpu = torch.device("cpu")
    monkeypatch.setattr(port_mesh, "process_devices", lambda backend: [cpu, cpu])


def _forced_sweep(package, types, **kw):
    ex = package.ShardExecutor(
        package.ShardConfig(max_nodes_per_shard=16, workers=1, device_solve=True),
        backend="auction", bucket=64, **kw,
    )
    return ex, _solve(ex, types)


def test_two_cards_ask_for_the_unported_sweep(monkeypatch):
    """With two devices every forced shard takes the multi-device sweep
    (a dp2×mp1 grid here, dp4×mp2 on the JAX package's eight virtual
    devices): the sweep's result does not depend on the grid, so the
    placements are the JAX package's."""
    _two_devices(monkeypatch)
    port, got = _forced_sweep(port_shard, port_types, device="cpu")
    ref, want = _forced_sweep(jax_shard, jax_types)
    assert port.last_routes == ref.last_routes == {"auction-sharded": port.last_shards_used}
    assert got == want and got[0]


def test_a_raising_sweep_propagates_instead_of_a_cpu_solve(monkeypatch):
    """The JAX package's executor catches a failing sweep and packs the
    shard natively; the port's lets it out."""
    _two_devices(monkeypatch)

    def lost(*a, **k):
        raise RuntimeError("block launch failed")

    monkeypatch.setattr(port_sharded, "sharded_place", lost)
    with pytest.raises(RuntimeError, match="block launch failed"):
        _forced_sweep(port_shard, port_types, device="cpu")


def test_an_attached_fleet_is_refused():
    """An attached fleet is asked for every keyed shard's solve; when it
    refuses them (its sidecar down: ``try_solve`` answers None) each is
    solved inline, with the placements of an executor that has no fleet."""

    class DecliningFleet:
        def __init__(self):
            self.asked = []

        def try_solve(self, sid, engine, policy, snapshot, batch, incumbent):
            self.asked.append((sid, engine))
            return None

    bare = port_shard.ShardExecutor(port_shard.ShardConfig(**CONFIG), backend="greedy")
    ex = port_shard.ShardExecutor(port_shard.ShardConfig(**CONFIG), backend="greedy")
    ex.remote = fleet = DecliningFleet()
    by_job, _ = _solve(ex, port_types)
    want, _ = _solve(bare, port_types)
    assert fleet.asked and {e for _, e in fleet.asked} == {"greedy"}
    assert by_job == want


def _sharded_scheduler(device="cpu"):
    partitions, nodes, demands = random_inventory(240, 700, seed=11)
    client, make_store = chip_smoke.port_tick_world(partitions, nodes, demands)
    store = make_store()
    sched = PlacementScheduler(
        store, client, backend="auction", inventory_ttl=0,
        auction_config=port_solver.AuctionConfig(rounds=4, candidates=0),
        shard=port_shard.ShardConfig(max_nodes_per_shard=32, workers=2, device_solve=False),
        device=device,
    )
    return sched, store


def test_the_scheduler_hands_its_device_to_the_executor():
    sched, _ = _sharded_scheduler()
    assert isinstance(sched.shard, port_shard.ShardExecutor)
    assert sched.shard.device == "cpu"
    assert sched.tick() > 0
    assert sched.shard.last_routes.get("auction", 0) >= 2


def test_a_raising_shard_device_solve_propagates_out_of_the_tick(monkeypatch):
    """No ``except`` turns a device failure into a native solve: the
    tick raises, and nothing is bound."""

    def lost(self, *a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(port_session.DeviceSolver, "solve", lost)
    sched, store = _sharded_scheduler()
    with pytest.raises(RuntimeError, match="device lost"):
        sched.tick()
    from slurm_bridge_tpu_torch.bridge.objects import Pod

    assert not any(p.spec.node_name for p in store.list(Pod.KIND))
