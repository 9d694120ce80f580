"""The port's lowering, host packers and routing: twins of the
tests/test_solver.py tests of those modules, plus equality with the JAX
package's copies on the same inputs."""

import pathlib

import numpy as np
import pytest
import torch

import slurm_bridge_tpu
import slurm_bridge_tpu.solver as J
from slurm_bridge_tpu.core.types import JobDemand as JJobDemand
from slurm_bridge_tpu.core.types import NodeInfo as JNodeInfo
from slurm_bridge_tpu.core.types import PartitionInfo as JPartitionInfo
from slurm_bridge_tpu.solver.indexed_native import indexed_place_native as j_indexed
from slurm_bridge_tpu.solver.snapshot import random_inventory as j_random_inventory
from slurm_bridge_tpu_torch import BUILD_DIR
from slurm_bridge_tpu_torch.core.types import JobDemand, NodeInfo, PartitionInfo
from slurm_bridge_tpu_torch.solver import (
    AuctionConfig,
    auction_place,
    encode_cluster,
    encode_jobs,
    greedy_place,
)
from slurm_bridge_tpu_torch.solver.snapshot import JobBatch, random_inventory, random_scenario
from tests.test_solver import _check_feasible, _pinned_case


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in parallel workers, and torch
    on every core in each starves the timing-sensitive tests beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _empty_batch():
    return JobBatch(
        demand=np.zeros((0, 3), np.float32),
        partition_of=np.zeros(0, np.int32),
        req_features=np.zeros(0, np.uint32),
        priority=np.zeros(0, np.float32),
        gang_id=np.zeros(0, np.int32),
        job_of=np.zeros(0, np.int32),
    )


def _placed_count(placement):
    return int(placement.placed.sum())


# ---------------------------------------------------------------- lowering


def test_encode_cluster_and_jobs():
    nodes = [
        NodeInfo(name="n1", cpus=32, memory_mb=64000, state="IDLE"),
        NodeInfo(name="n2", cpus=32, alloc_cpus=16, memory_mb=64000, state="MIXED"),
        NodeInfo(name="g1", cpus=64, memory_mb=128000, gpus=4, gpu_type="a100",
                 features=("a100",), state="IDLE"),
        NodeInfo(name="bad", cpus=32, memory_mb=64000, state="DOWN"),
    ]
    parts = [
        PartitionInfo(name="debug", nodes=("n1", "n2", "bad")),
        PartitionInfo(name="gpu", nodes=("g1",)),
    ]
    snap = encode_cluster(nodes, parts)
    assert snap.num_nodes == 4
    assert snap.free[0, 0] == 32 and snap.free[1, 0] == 16
    assert snap.free[3].sum() == 0  # DOWN node advertises nothing
    assert snap.partition_of.tolist() == [0, 0, 1, 0]
    assert snap.features[2] != 0
    jobs = [
        JobDemand(partition="debug", cpus_per_task=2, ntasks=4),
        JobDemand(partition="gpu", gres="gpu:a100:2", cpus_per_task=8),
        JobDemand(partition="debug", nodes=2, ntasks=2, cpus_per_task=4),
        JobDemand(partition="debug", array="0-3", cpus_per_task=1),
    ]
    batch = encode_jobs(jobs, snap)
    assert batch.num_shards == 5
    assert batch.demand[0, 0] == 8  # 2cpu × 4 tasks
    assert batch.demand[1, 2] == 2  # gpus
    assert (batch.gang_id == 2).sum() == 2
    assert batch.demand[4, 0] == 4  # array 0-3 → ×4 cpus


def _to_jax_types(parts, nodes, demands):
    """The port's typed inventory as the JAX package's dataclasses (same
    fields, copied value for value)."""
    from dataclasses import asdict

    return (
        [JPartitionInfo(**asdict(p)) for p in parts],
        [JNodeInfo(**asdict(n)) for n in nodes],
        [JJobDemand(**asdict(d)) for d in demands],
    )


@pytest.mark.parametrize("seed", [0, 7])
def test_encoders_equal_jax(seed):
    """The same typed inventory lowers to identical arrays in both packages."""
    parts, nodes, demands = random_inventory(300, 900, seed=seed, drain_fraction=0.05)
    jparts, jnodes, jdemands = j_random_inventory(300, 900, seed=seed, drain_fraction=0.05)
    assert _to_jax_types(parts, nodes, demands) == (jparts, jnodes, jdemands)
    snap = encode_cluster(nodes, parts)
    jsnap = J.encode_cluster(jnodes, jparts)
    for k in ("capacity", "free", "partition_of", "features"):
        np.testing.assert_array_equal(getattr(snap, k), getattr(jsnap, k))
    batch, jbatch = encode_jobs(demands, snap), J.encode_jobs(jdemands, jsnap)
    for k in ("demand", "partition_of", "req_features", "priority", "gang_id", "job_of"):
        np.testing.assert_array_equal(getattr(batch, k), getattr(jbatch, k))


@pytest.mark.parametrize("seed", [0, 4])
def test_random_scenario_equals_jax(seed):
    kw = dict(seed=seed, load=0.7, gpu_fraction=0.15, gang_fraction=0.05)
    snap, batch = random_scenario(200, 700, **kw)
    jsnap, jbatch = J.snapshot.random_scenario(200, 700, **kw)
    for k in ("capacity", "free", "partition_of", "features"):
        np.testing.assert_array_equal(getattr(snap, k), getattr(jsnap, k))
    for k in ("demand", "partition_of", "req_features", "priority", "gang_id", "job_of"):
        np.testing.assert_array_equal(getattr(batch, k), getattr(jbatch, k))


def test_encoder_cache_delta_refresh():
    from slurm_bridge_tpu_torch.solver.encoder import EncodedInventory, JobRowCache

    parts, nodes, demands = random_inventory(50, 120, seed=2)
    inv = EncodedInventory()
    snap = inv.refresh(nodes, parts)
    assert inv.refresh(nodes, parts).num_nodes == snap.num_nodes
    assert inv.last_delta_rows == 0
    nodes2 = list(nodes)
    nodes2[3] = NodeInfo(**{**nodes[3].__dict__, "state": "DRAINED"})
    snap2 = inv.refresh(nodes2, parts)
    assert inv.last_delta_rows == 1 and snap2.free[3].sum() == 0
    cache = JobRowCache()
    keys = [(i, 0) for i in range(len(demands))]
    b1 = cache.encode(keys, demands, snap2, codes_token=inv.codes_token())
    b2 = cache.encode(keys, demands, snap2, codes_token=inv.codes_token())
    assert cache.last_hits == len(demands) and cache.last_misses == 0
    np.testing.assert_array_equal(b1.demand, b2.demand)
    np.testing.assert_array_equal(b1.demand, encode_jobs(demands, snap2).demand)
    from slurm_bridge_tpu_torch.obs.metrics import REGISTRY

    text = REGISTRY.render()
    assert 'sbt_scheduler_encode_cache_hits_total{cache="jobs",kind="row"}' in text
    assert 'sbt_scheduler_encode_cache_misses_total{cache="inventory"}' in text


# ---------------------------------------------------------------- greedy


def test_greedy_simple():
    snap, batch = random_scenario(16, 40, seed=1, load=0.5)
    pl = greedy_place(snap, batch)
    _check_feasible(snap, batch, pl)
    assert _placed_count(pl) > 0


def test_greedy_respects_capacity_exactly():
    nodes = [NodeInfo(name="n1", cpus=4, memory_mb=4096, state="IDLE")]
    parts = [PartitionInfo(name="p", nodes=("n1",))]
    snap = encode_cluster(nodes, parts)
    jobs = [JobDemand(partition="p", cpus_per_task=3, mem_per_cpu_mb=1024),
            JobDemand(partition="p", cpus_per_task=3, mem_per_cpu_mb=1024)]
    batch = encode_jobs(jobs, snap, priorities=[10, 5])
    assert greedy_place(snap, batch).placed.tolist() == [True, False]


def test_greedy_gang_all_or_nothing():
    nodes = [NodeInfo(name=f"n{i}", cpus=4, memory_mb=8192, state="IDLE") for i in range(2)]
    parts = [PartitionInfo(name="p", nodes=tuple(n.name for n in nodes))]
    snap = encode_cluster(nodes, parts)
    jobs = [JobDemand(partition="p", nodes=3, ntasks=3, cpus_per_task=2),
            JobDemand(partition="p", cpus_per_task=1)]
    batch = encode_jobs(jobs, snap, priorities=[100, 1])
    pl = greedy_place(snap, batch)
    assert not pl.placed[:3].any()
    assert pl.placed[3]


@pytest.mark.parametrize("seed", [0, 5])
def test_greedy_equals_jax(seed):
    snap, batch = random_scenario(48, 300, seed=seed, load=0.9, gpu_fraction=0.2, gang_fraction=0.15)
    np.testing.assert_array_equal(
        greedy_place(snap, batch).node_of, J.greedy_place(snap, batch).node_of
    )


# ---------------------------------------------------------------- native packers


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_native_greedy_matches_python(seed):
    from slurm_bridge_tpu_torch.solver.greedy_native import greedy_place_native

    snap, batch = random_scenario(48, 300, seed=seed, load=0.7,
                                  gpu_fraction=0.2, gang_fraction=0.1)
    py = greedy_place(snap, batch)
    nat = greedy_place_native(snap, batch)
    assert np.array_equal(py.node_of, nat.node_of)
    assert np.allclose(py.free_after, nat.free_after, atol=1e-3)


def test_native_greedy_empty():
    from slurm_bridge_tpu_torch.solver.greedy_native import greedy_place_native

    snap, _ = random_scenario(8, 10, seed=0)
    assert greedy_place_native(snap, _empty_batch()).node_of.shape == (0,)


@pytest.mark.parametrize("seed", [0, 3, 13])
def test_indexed_native_matches_python_and_jax(seed):
    from slurm_bridge_tpu_torch.solver.indexed_native import indexed_place_native

    snap, batch = random_scenario(48, 300, seed=seed, load=0.9,
                                  gpu_fraction=0.2, gang_fraction=0.15)
    py = greedy_place(snap, batch)
    idx = indexed_place_native(snap, batch)
    assert np.array_equal(py.node_of, idx.node_of)
    assert np.allclose(py.free_after, idx.free_after, atol=1e-3)
    assert np.array_equal(idx.node_of, j_indexed(snap, batch).node_of)


def test_indexed_native_empty():
    from slurm_bridge_tpu_torch.solver.indexed_native import indexed_place_native

    snap, _ = random_scenario(8, 10, seed=0)
    assert indexed_place_native(snap, _empty_batch()).node_of.shape == (0,)


def test_indexed_native_any_partition_and_unknown_features():
    from slurm_bridge_tpu_torch.solver.indexed_native import indexed_place_native

    snap, base = random_scenario(24, 60, seed=6, load=0.6, gpu_fraction=0.3)
    part = base.partition_of.copy()
    part[::3] = -1
    feat = base.req_features.copy()
    feat[1] = np.uint32(1 << 31)  # reserved impossible bit
    batch = JobBatch(
        demand=base.demand, partition_of=part, req_features=feat,
        priority=base.priority, gang_id=base.gang_id, job_of=base.job_of,
    )
    py = greedy_place(snap, batch)
    idx = indexed_place_native(snap, batch)
    assert np.array_equal(py.node_of, idx.node_of)
    assert not idx.placed[1]


@pytest.mark.parametrize("policy", ["best", "first", "worst"])
def test_indexed_native_policies_and_pins_match_python(policy):
    from slurm_bridge_tpu_torch.solver.indexed_native import indexed_place_native

    snap, batch, inc = _pinned_case(64, 400, seed=1, load=0.9)
    for pins in (None, inc):
        py = greedy_place(snap, batch, incumbent=pins, policy=policy)
        idx = indexed_place_native(snap, batch, incumbent=pins, policy=policy)
        assert np.array_equal(py.node_of, idx.node_of), (policy, pins is None)
        assert np.allclose(py.free_after, idx.free_after, atol=1e-3)


def test_indexed_native_pinned_rejects_out_of_range_pin():
    from slurm_bridge_tpu_torch.solver.indexed_native import indexed_place_native

    snap, batch = random_scenario(8, 10, seed=0)
    inc = np.full(batch.num_shards, -1, np.int32)
    inc[0] = snap.num_nodes
    with pytest.raises(ValueError, match="out of range"):
        indexed_place_native(snap, batch, incumbent=inc)


def test_indexed_native_build_failure_falls_back(monkeypatch):
    import slurm_bridge_tpu_torch.solver.indexed_native as inat
    from slurm_bridge_tpu_torch.solver.nativelib import NativeBuildError

    def boom(*a, **k):
        raise NativeBuildError("g++ unavailable (simulated)")

    monkeypatch.setattr(inat, "load_symbol", boom)
    monkeypatch.setattr(inat, "_build_failed", False)
    snap, batch = random_scenario(16, 40, seed=1, gang_fraction=0.2)
    pl = inat.indexed_place_native(snap, batch)
    assert np.array_equal(pl.node_of, greedy_place(snap, batch).node_of)
    assert inat._build_failed


def test_native_build_writes_only_into_the_port_build_dir():
    """The port compiles the packers into its own gitignored build
    directory — never next to its sources, never under slurm_bridge_tpu/."""
    import shutil

    import slurm_bridge_tpu_torch.ops.bid_argmax as kern
    import slurm_bridge_tpu_torch.solver.greedy_native as gnat
    import slurm_bridge_tpu_torch.solver.indexed_native as inat

    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain here")
    ref_pkg = pathlib.Path(slurm_bridge_tpu.__file__).resolve().parent
    snap, batch = random_scenario(8, 20, seed=0)
    inat.indexed_place_native(snap, batch)
    gnat.greedy_place_native(snap, batch)
    assert not inat._build_failed
    for lib in (inat._LIB, gnat._LIB, kern._LIB):
        assert lib.parent == BUILD_DIR
        assert ref_pkg not in lib.resolve().parents
    assert inat._LIB.exists() and gnat._LIB.exists()
    assert BUILD_DIR.name == "_build" and BUILD_DIR.parent.name == "slurm_bridge_tpu_torch"


# ---------------------------------------------------------------- routing


def test_choose_path_rules(monkeypatch):
    from slurm_bridge_tpu_torch.solver.routing import DISPATCH_FLOOR_CELLS, choose_path

    assert choose_path(50_000, 10_000, backend_name="cpu") == "native"
    assert choose_path(10, 10, backend_name="cpu") == "native"
    assert choose_path(50_000, 10_000, backend_name="cuda") == "device"
    assert choose_path(57_635, 10_000, backend_name="cuda") == "device"
    assert choose_path(5_000, 512, backend_name="cuda") == "native"
    assert 5_000 * 512 < DISPATCH_FLOOR_CELLS <= 50_000 * 10_000
    monkeypatch.setenv("SBT_ROUTE_FLOOR_CELLS", "100")
    assert choose_path(5_000, 512, backend_name="cuda") == "device"
    monkeypatch.setenv("SBT_ROUTE_FLOOR_CELLS", "bogus")
    with pytest.raises(ValueError, match="SBT_ROUTE_FLOOR_CELLS"):
        choose_path(5_000, 512, backend_name="cuda")


def test_choose_path_default_backend_needs_the_card(monkeypatch):
    """With no backend named, routing asks ensure_backend: CPU only when
    asked for, never as a silent fallback."""
    import torch

    from slurm_bridge_tpu_torch.parallel.backend import BackendUnavailable
    from slurm_bridge_tpu_torch.solver.routing import choose_path

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SBT_BACKEND", raising=False)
    with pytest.raises(BackendUnavailable):
        choose_path(50_000, 10_000)
    monkeypatch.setenv("SBT_BACKEND", "cpu")
    assert choose_path(50_000, 10_000) == "native"


def test_choose_path_gang_and_incumbent_dominance():
    from slurm_bridge_tpu_torch.solver.routing import (
        choose_path,
        gang_shard_fraction,
        incumbent_fraction,
    )

    assert choose_path(12_000, 10_000, backend_name="cuda", gang_fraction=0.89) == "native"
    assert choose_path(50_000, 10_000, backend_name="cuda", gang_fraction=0.17) == "device"
    assert choose_path(50_000, 10_000, backend_name="cuda", inc_fraction=0.98) == "native"
    assert choose_path(50_000, 10_000, backend_name="cuda", inc_fraction=0.2) == "device"
    snap, batch = random_scenario(64, 600, seed=4, gang_fraction=0.5, gang_size=8)
    assert 0.85 < gang_shard_fraction(batch.gang_id) < 0.95
    assert gang_shard_fraction(np.zeros(0, np.int32)) == 0.0
    assert incumbent_fraction(np.array([3, -1, 7, 2], np.int32)) == 0.75


def test_native_fit_policy_selection(monkeypatch):
    from slurm_bridge_tpu_torch.solver.routing import native_fit_policy

    assert native_fit_policy() == "worst"
    assert native_fit_policy(has_pins=True) == "best"
    monkeypatch.setenv("SBT_NATIVE_FIT", "bogus")
    with pytest.raises(ValueError, match="SBT_NATIVE_FIT"):
        native_fit_policy()


# ---------------------------------------------------------------- auction (CPU)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auction_feasibility(seed):
    snap, batch = random_scenario(32, 200, seed=seed, load=0.6,
                                  gpu_fraction=0.2, gang_fraction=0.1)
    _check_feasible(snap, batch, auction_place(snap, batch, device="cpu"))


def test_auction_vs_greedy_quality():
    snap, batch = random_scenario(64, 400, seed=7, load=0.6)
    g = greedy_place(snap, batch)
    a = auction_place(snap, batch, AuctionConfig(rounds=12), device="cpu")
    _check_feasible(snap, batch, a)
    assert _placed_count(a) >= 0.9 * _placed_count(g)


def test_auction_empty_batch():
    snap, _ = random_scenario(8, 10, seed=0)
    assert auction_place(snap, _empty_batch(), device="cpu").node_of.shape == (0,)


def test_auction_priority_wins_scarce_node():
    nodes = [NodeInfo(name="n1", cpus=4, memory_mb=4096, state="IDLE")]
    parts = [PartitionInfo(name="p", nodes=("n1",))]
    snap = encode_cluster(nodes, parts)
    jobs = [JobDemand(partition="p", cpus_per_task=3, mem_per_cpu_mb=1024),
            JobDemand(partition="p", cpus_per_task=3, mem_per_cpu_mb=1024)]
    batch = encode_jobs(jobs, snap, priorities=[1, 99])
    for use in (False, True):
        pl = auction_place(snap, batch, AuctionConfig(use_pallas=use), device="cpu")
        assert pl.placed.tolist() == [False, True]


def test_repair_only_adds_and_respects_capacity():
    snap, batch = random_scenario(96, 700, seed=17, load=1.2, gang_fraction=0.5, gang_size=4)
    base = auction_place(snap, batch, AuctionConfig(rounds=4, repair=False), device="cpu")
    fixed = auction_place(snap, batch, AuctionConfig(rounds=4, repair=True), device="cpu")
    kernel_rows = base.placed
    assert np.array_equal(base.node_of[kernel_rows], fixed.node_of[kernel_rows])
    assert fixed.placed.sum() >= base.placed.sum()
    _check_feasible(snap, batch, fixed)


def test_repair_skips_incumbent_pinned_gangs():
    from slurm_bridge_tpu_torch.solver.auction import repair_unplaced
    from slurm_bridge_tpu_torch.solver.snapshot import Placement

    snap, batch = random_scenario(16, 12, seed=3, gang_fraction=1.0, gang_size=2)
    p = batch.num_shards
    placement = Placement(
        node_of=np.full(p, -1, np.int32), placed=np.zeros(p, bool),
        free_after=snap.free.copy(),
    )
    incumbent = np.full(p, -1, np.int32)
    incumbent[0] = 0
    out = repair_unplaced(snap, batch, placement, incumbent=incumbent)
    pinned_gang = batch.gang_id[0]
    assert not out.placed[batch.gang_id == pinned_gang].any()
    assert out.placed[batch.gang_id != pinned_gang].any()


def test_gang_ids_arbitrary_values():
    snap, batch = random_scenario(16, 40, seed=1, gang_fraction=0.3, gang_size=2)
    batch.gang_id = (batch.gang_id.astype(np.int64) + 123456).astype(np.int32)
    _check_feasible(snap, batch, auction_place(snap, batch, AuctionConfig(rounds=8), device="cpu"))


def test_sampled_auction_finds_tiny_partition():
    nodes = [NodeInfo(name=f"n{i}", cpus=16, memory_mb=32768) for i in range(512)]
    parts = [
        PartitionInfo(name="big", nodes=tuple(f"n{i}" for i in range(4, 512))),
        PartitionInfo(name="tiny", nodes=("n0", "n1", "n2", "n3")),
    ]
    snap = encode_cluster(nodes, parts)
    batch = encode_jobs([JobDemand(partition="tiny", cpus_per_task=1) for _ in range(8)], snap)
    pl = auction_place(snap, batch, AuctionConfig(rounds=4, candidates=8), device="cpu")
    assert pl.placed.all()
    assert all(snap.partition_of[nd] == snap.partition_codes["tiny"] for nd in pl.node_of)


def test_sampled_auction_finds_rare_feature_nodes():
    nodes = [
        NodeInfo(name=f"n{i}", cpus=16, memory_mb=32768, gpus=4 if i < 4 else 0,
                 features=("h100",) if i < 4 else ())
        for i in range(2048)
    ]
    parts = [PartitionInfo(name="all", nodes=tuple(n.name for n in nodes))]
    snap = encode_cluster(nodes, parts)
    demands = [
        JobDemand(partition="all", cpus_per_task=1, gres="gpu:h100:1") for _ in range(4)
    ] + [JobDemand(partition="all", cpus_per_task=1) for _ in range(64)]
    batch = encode_jobs(demands, snap)
    pl = auction_place(snap, batch, AuctionConfig(rounds=4, candidates=8), device="cpu")
    assert pl.placed.all()
    assert (pl.node_of[:4] < 4).all()


def test_candidate_pools_grow_and_restage():
    from slurm_bridge_tpu_torch.solver.auction import CandidatePools

    nodes = [
        NodeInfo(name=f"n{i}", cpus=8, memory_mb=8192,
                 features=("a100",) if i % 2 else ("h100",))
        for i in range(32)
    ]
    parts = [PartitionInfo(name="all", nodes=tuple(n.name for n in nodes))]
    snap = encode_cluster(nodes, parts)
    pools = CandidatePools(snap)
    v0 = pools.version
    b1 = encode_jobs([JobDemand(partition="all", gres="gpu:h100:1")], snap)
    s1, c1 = pools.slices(b1)
    assert pools.version > v0 and c1[0] == 16
    v1 = pools.version
    s2, c2 = pools.slices(b1)
    assert pools.version == v1 and s2[0] == s1[0] and c2[0] == 16
    assert len(pools.array) % snap.num_nodes == 0


def test_sampled_incumbent_revalidated_against_node_changes():
    from slurm_bridge_tpu_torch.solver.snapshot import ClusterSnapshot

    def snap_two_nodes(node0_part, node0_feat):
        return ClusterSnapshot(
            node_names=["h0", "h1"],
            capacity=np.full((2, 3), 64, np.float32),
            free=np.full((2, 3), 64, np.float32),
            partition_of=np.array([node0_part, 1], np.int32),
            features=np.array([node0_feat, 0], np.uint32),
            partition_codes={"a": 0, "b": 1},
            feature_codes={"f": 0},
        )

    batch = JobBatch(
        demand=np.full((1, 3), 4, np.float32), partition_of=np.array([0], np.int32),
        req_features=np.array([1], np.uint32), priority=np.ones(1, np.float32),
        gang_id=np.zeros(1, np.int32), job_of=np.zeros(1, np.int32),
    )
    incumbent = np.array([0], np.int32)
    for snap in (snap_two_nodes(1, 1), snap_two_nodes(0, 0)):
        for k in (0, 2):
            pl = auction_place(
                snap, batch, AuctionConfig(rounds=4, candidates=k), incumbent=incumbent,
                device="cpu",
            )
            assert not pl.placed[0]
