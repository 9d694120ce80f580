"""The port's multi-device sweep against the JAX package's, on the CPU.

The JAX package's tests run its ``shard_map`` sweep on eight virtual CPU
devices (``tests/conftest.py``); the port's runs on eight CPU blocks, the
device list patched the same way (:func:`eight_cpu_devices`). The same
seeded inputs through both packages' ``sharded_place`` on the same dp×mp
grid must give the same ``node_of`` and ``free_after``, bit for bit. The
reference's own sharded tests (``tests/test_solver.py``'s sharded section)
are held here against the port; a simulator run with every shard on the
sweep is a digest twin.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import slurm_bridge_tpu.parallel.colpool as jax_colpool
import slurm_bridge_tpu.sim as jax_sim
import slurm_bridge_tpu.sim.scenarios as jax_scenarios
import slurm_bridge_tpu.solver.auction as ja
import slurm_bridge_tpu.solver.sharded as jsh
import slurm_bridge_tpu_torch.ops.bid_argmax as kern
import slurm_bridge_tpu_torch.parallel.colpool as port_colpool
import slurm_bridge_tpu_torch.parallel.mesh as port_mesh
import slurm_bridge_tpu_torch.sim as port_sim
import slurm_bridge_tpu_torch.sim.scenarios as port_scenarios
import slurm_bridge_tpu_torch.solver.sharded as tsh
from slurm_bridge_tpu.parallel.mesh import solver_mesh as jax_mesh
from slurm_bridge_tpu.solver.snapshot import ClusterSnapshot, JobBatch, random_scenario
from slurm_bridge_tpu_torch.solver.auction import AuctionConfig, auction_place
from slurm_bridge_tpu_torch.solver.convert import batch_from, snapshot_from
from tests.test_solver import _check_feasible, _placed_count

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def eight_cpu_devices(monkeypatch):
    """The port's process devices as eight CPU blocks — what
    ``tests/conftest.py``'s eight virtual XLA devices are to the JAX
    package."""
    real = port_mesh.process_devices
    monkeypatch.setattr(
        port_mesh, "process_devices",
        lambda backend: [CPU] * 8 if backend == "cpu" else real(backend),
    )
    monkeypatch.setenv("SBT_BACKEND", "cpu")


def _port_mesh(dp, mp):
    return port_mesh.solver_mesh([CPU] * (dp * mp), dp=dp, mp=mp)


def _both(snap, batch, dp, mp, cfg=None, incumbent=None, port_cfg=None):
    """(JAX placement, port placement) of one sweep on a dp×mp grid: the
    JAX package's jnp block path on its virtual devices, the port's on
    CPU blocks."""
    cfg = cfg or {}
    jm = jax_mesh(jax.devices()[: dp * mp], dp=dp, mp=mp)
    want = jsh.sharded_place(
        snap, batch, ja.AuctionConfig(**cfg, use_pallas=False), mesh=jm,
        incumbent=incumbent,
    )
    got = tsh.sharded_place(
        snapshot_from(snap), batch_from(batch), AuctionConfig(**cfg, **(port_cfg or {})),
        mesh=_port_mesh(dp, mp), incumbent=incumbent, device="cpu",
    )
    return want, got


def _equal(want, got):
    np.testing.assert_array_equal(got.node_of, want.node_of)
    np.testing.assert_array_equal(got.placed, want.placed)
    np.testing.assert_array_equal(got.free_after, want.free_after)


# ------------------------------------------ the reference's sharded tests


def test_solver_mesh_shapes(eight_cpu_devices):
    mesh = port_mesh.solver_mesh()
    assert mesh.shape["dp"] * mesh.shape["mp"] == len(jax.devices()) == 8
    assert mesh.shape == dict(jax_mesh().shape)
    assert mesh.axis_names == ("dp", "mp") and mesh.devices.shape == (4, 2)


def test_solver_mesh_partial_factors(eight_cpu_devices):
    m = port_mesh.solver_mesh(dp=8)
    assert m.shape["dp"] == 8 and m.shape["mp"] == 1
    m = port_mesh.solver_mesh(mp=4)
    assert m.shape["mp"] == 4 and m.shape["dp"] == 2
    for bad in (dict(dp=3), dict(mp=3), dict(dp=4, mp=4)):
        with pytest.raises(ValueError):
            port_mesh.solver_mesh(**bad)
        with pytest.raises(ValueError):
            jax_mesh(**bad)


@pytest.mark.parametrize("seed", [0, 4])
def test_sharded_matches_quality(eight_cpu_devices, seed):
    snap, batch = random_scenario(33, 197, seed=seed, load=0.6,
                                  gpu_fraction=0.2, gang_fraction=0.1)
    snap, batch = snapshot_from(snap), batch_from(batch)
    # deliberately non-divisible sizes to exercise padding
    single = auction_place(snap, batch, AuctionConfig(rounds=10), device="cpu")
    multi = tsh.sharded_place(snap, batch, AuctionConfig(rounds=10), device="cpu")
    _check_feasible(snap, batch, multi)
    assert _placed_count(multi) >= 0.95 * _placed_count(single), (
        f"sharded {_placed_count(multi)} vs single {_placed_count(single)}"
    )


def test_sharded_deterministic(eight_cpu_devices):
    snap, batch = random_scenario(16, 64, seed=2)
    snap, batch = snapshot_from(snap), batch_from(batch)
    a = tsh.sharded_place(snap, batch)
    b = tsh.sharded_place(snap, batch)
    assert np.array_equal(a.node_of, b.node_of)


# ------------------------------------------------- port against the JAX package


#: (nodes, jobs, seed, gang fraction, dp, mp): every grid shape, P and N
#: not divisible by the grid, gangs
SWEEPS = [
    (33, 197, 0, 0.1, 4, 2),
    (64, 200, 7, 0.1, 2, 2),
    (50, 120, 3, 0.0, 8, 1),
    (40, 100, 1, 0.2, 1, 1),
    (37, 150, 5, 0.3, 2, 4),
    (5, 7, 5, 0.0, 8, 1),  # fewer shards than rows of the grid
]


@pytest.mark.parametrize("nodes,jobs,seed,gangs,dp,mp", SWEEPS)
@pytest.mark.parametrize("kernel", [False, True], ids=["dense", "kernel"])
def test_sweep_equals_the_jax_package(nodes, jobs, seed, gangs, dp, mp, kernel):
    """The dense block path, and the kernel's route (its plain version on
    CPU tensors), against the JAX package's jnp block path."""
    snap, batch = random_scenario(nodes, jobs, seed=seed, load=0.7,
                                  gpu_fraction=0.2, gang_fraction=gangs)
    want, got = _both(snap, batch, dp, mp, dict(rounds=6),
                      port_cfg=dict(use_pallas=kernel))
    _equal(want, got)


@pytest.mark.parametrize("dp,mp", [(4, 2), (2, 2)])
@pytest.mark.parametrize("kernel", [False, True], ids=["dense", "kernel"])
def test_sweep_with_incumbents_equals_the_jax_package(dp, mp, kernel):
    """Streaming incumbents bid only on the global node they hold: each
    block compares them with its global node ids."""
    snap, batch = random_scenario(37, 150, seed=2, load=0.7, gpu_fraction=0.2,
                                  gang_fraction=0.15)
    base = ja.auction_place(snap, batch, ja.AuctionConfig(rounds=4, use_pallas=False))
    rng = np.random.default_rng(2)
    inc = np.where(base.placed & (rng.random(batch.num_shards) < 0.6),
                   base.node_of, -1).astype(np.int32)
    want, got = _both(snap, batch, dp, mp, dict(rounds=6), incumbent=inc,
                      port_cfg=dict(use_pallas=kernel))
    _equal(want, got)
    assert got.placed[inc >= 0].any()


@pytest.mark.parametrize("cfg", [
    dict(gang_first=True), dict(affinity_weight=0.3), dict(repair=False),
    dict(dtype="bfloat16"), dict(gang_salvage_rounds=0, eta=0.25, jitter=0.5),
], ids=["gang_first", "affinity", "no_repair", "bfloat16", "knobs"])
def test_sweep_config_knobs_equal_the_jax_package(cfg):
    snap, batch = random_scenario(37, 150, seed=5, load=0.8, gpu_fraction=0.2,
                                  gang_fraction=0.15)
    want, got = _both(snap, batch, 2, 2, dict(rounds=6, **cfg))
    _equal(want, got)


@pytest.mark.parametrize("empty", ["jobs", "nodes"])
def test_empty_queue_or_inventory_equals_the_jax_package(empty):
    snap, batch = random_scenario(12, 30, seed=3)
    if empty == "jobs":
        batch = batch.select(np.zeros(batch.num_shards, bool))
    else:
        keep = np.zeros(snap.num_nodes, bool)
        snap = dataclasses.replace(
            snap, node_names=[], capacity=snap.capacity[keep], free=snap.free[keep],
            partition_of=snap.partition_of[keep], features=snap.features[keep],
        )
    want, got = _both(snap, batch, 2, 2, dict(rounds=3))
    _equal(want, got)
    assert not got.placed.any()


def _tie_world(n_nodes=8, free_from=3):
    """One shard and ``n_nodes`` nodes of one partition, of which only
    nodes ``free_from`` and on have room; with no jitter every feasible
    node bids exactly the same (−price = 0 in round 0)."""
    cap = np.tile(np.float32([8, 8192, 0]), (n_nodes, 1))
    free = cap.copy()
    free[:free_from] = 0.0
    snap = ClusterSnapshot(
        node_names=[f"n{i}" for i in range(n_nodes)], capacity=cap, free=free,
        partition_of=np.zeros(n_nodes, np.int32), features=np.zeros(n_nodes, np.uint32),
        partition_codes={"p": 0}, feature_codes={},
    )
    batch = JobBatch(
        demand=np.float32([[2, 1024, 0]]), partition_of=np.int32([0]),
        req_features=np.uint32([0]), priority=np.float32([1.0]),
        gang_id=np.int32([0]), job_of=np.int32([0]),
    )
    return snap, batch


@pytest.mark.parametrize("kernel", [False, True], ids=["dense", "kernel"])
def test_tie_on_a_node_block_boundary_goes_to_the_first_block(kernel):
    """Nodes 3 (the last of block 0) and 4 (the first of block 1) tie
    exactly: the first block wins, as the lowest index does inside one."""
    snap, batch = _tie_world()
    want, got = _both(snap, batch, 1, 2, dict(rounds=1, jitter=0.0, repair=False),
                      port_cfg=dict(use_pallas=kernel))
    _equal(want, got)
    assert got.node_of.tolist() == [3]


def test_no_feasible_node_in_any_block_is_no_choice():
    """Every block's value is −inf: the combine must come out "no choice"
    (the row stays unplaced), not node 0 of the first block."""
    snap, batch = _tie_world(free_from=8)
    vals = [[torch.full((1,), float("-inf"))] * 2]
    nodes = [[torch.tensor([0], dtype=torch.int32), torch.tensor([4], dtype=torch.int32)]]
    bval, _ = tsh.combine_blocks(vals, nodes, CPU)
    assert not torch.isfinite(bval).any()
    want, got = _both(snap, batch, 1, 2, dict(rounds=2, repair=False),
                      port_cfg=dict(use_pallas=True))
    _equal(want, got)
    assert got.node_of.tolist() == [-1]


def test_padded_node_block_reaches_bid_argmax(monkeypatch):
    """N = 7 on mp = 2: block 1 holds a pad node (partition 2**30, free
    −1). Its node order for the kernel files the pad node apart (the
    order stays dense, where the raw code would be refused); the kernel's
    route, its plain version here, never chooses it; the result is the JAX
    package's."""
    with pytest.raises(ValueError, match="not dense"):
        kern.node_order(np.int32([0, 1, 2**30]), CPU)
    calls = []
    real = tsh.bid_argmax

    def recording(*args, **kw):
        calls.append((args[1].clone(), kw["n_base"], kw["nodes"]))
        return real(*args, **kw)

    monkeypatch.setattr(tsh, "bid_argmax", recording)
    snap, batch = random_scenario(7, 40, seed=6, load=0.6)
    want, got = _both(snap, batch, 2, 2, dict(rounds=4), port_cfg=dict(use_pallas=True))
    _equal(want, got)
    padded = [(part, order) for part, n_base, order in calls if n_base == 4]
    assert padded and len(calls) == 4 * 4
    part, (order, offsets) = padded[0]
    assert part.tolist()[-1] == 2**30 and order[0].item() == 3  # pad node first
    assert offsets[0].item() == 1  # partition 0's run starts after it
    assert (got.node_of < 7).all()


# ------------------------------------------------------ the simulator's twin


def test_sharded_smoke_with_every_shard_on_the_sweep(eight_cpu_devices, monkeypatch):
    """``sharded_smoke`` with ``device_solve=True``: every shard solves on
    the multi-device sweep, the JAX package's on its eight virtual devices,
    the port's on eight CPU blocks (a dp4×mp2 grid each). Scale 0.05 keeps
    the pair under a minute: the JAX side compiles one ``shard_map`` per
    block shape."""
    monkeypatch.setenv("SBT_COLPOOL_WORKERS", "2")

    def forced(scenarios):
        sc = scenarios.SCENARIOS["sharded_smoke"](scale=0.05)
        return dataclasses.replace(
            sc, sharding=dataclasses.replace(sc.sharding, device_solve=True)
        )

    routes = []
    real = tsh.sharded_place

    def counting(*args, **kw):
        routes.append(kw.get("mesh"))
        return real(*args, **kw)

    monkeypatch.setattr(tsh, "sharded_place", counting)
    try:
        ref = jax_sim.run_scenario(forced(jax_scenarios))
        port = port_sim.run_scenario(forced(port_scenarios), device="cpu")
    finally:
        port_colpool.reset()
        jax_colpool.reset()
    assert routes, "no shard took the sweep"
    for key in ("digest", "final_state_digest", "bound_total", "events",
                "invariant_violations"):
        assert port.determinism[key] == ref.determinism[key], key
    assert port.determinism_json() == ref.determinism_json()


def test_the_sweep_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    """No silent CPU solve: without a card, ``device="cpu"`` or
    ``SBT_BACKEND=cpu`` the sweep raises before it builds a block."""
    from slurm_bridge_tpu_torch.parallel.backend import BackendUnavailable

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    monkeypatch.delenv("SBT_BACKEND", raising=False)
    snap, batch = random_scenario(12, 30, seed=3)
    with pytest.raises(BackendUnavailable):
        tsh.sharded_place(snapshot_from(snap), batch_from(batch), mesh=_port_mesh(2, 2))
