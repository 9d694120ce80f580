"""Card-only tests: the CUDA kernel against its plain version, and the
solve and the placement tick on the card against the same on the CPU.

They skip where no card is present (the check is made inside the fixture,
so every worker collects the same tests). This file imports neither JAX
nor the JAX package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import slurm_bridge_tpu_torch.ops.bid_argmax as kern
from slurm_bridge_tpu_torch.solver import AuctionConfig, DeviceSolver, auction_place
from slurm_bridge_tpu_torch.solver.snapshot import random_scenario


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in parallel workers, and torch
    on every core in each starves the timing-sensitive tests beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _op_inputs(seed, n, p, device):
    """The op's inputs from a seed (tests/test_ops.py's distribution),
    as the port's tensors on ``device``."""
    rng = np.random.default_rng(seed)
    free = rng.uniform(0, 64, (n, 3)).astype(np.float32)
    dem = rng.uniform(0, 32, (p, 3)).astype(np.float32)
    scale = np.float32(1.0) / np.maximum(free.mean(0), 1)
    arrays = [
        free,
        rng.integers(0, 4, n).astype(np.int32),
        rng.integers(0, 4, n).astype(np.int32),
        rng.uniform(0, 1, n).astype(np.float32),
        dem,
        rng.integers(-1, 4, p).astype(np.int32),
        rng.integers(0, 4, p).astype(np.int32),
        np.where(rng.random(p) < 0.3, rng.integers(0, n, p), -1).astype(np.int32),
        (dem * scale).astype(np.float32),
        (free * scale).astype(np.float32),
    ]
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(700, 300), (33, 1000), (1, 1), (4099, 515)])
@pytest.mark.parametrize("aw", [0.0, 0.3])
def test_kernel_bit_exact_with_plain(cuda, n, p, aw):
    args = _op_inputs(n + p, n, p, cuda)
    kw = dict(jitter=1.0, affinity_weight=aw, num_nodes=n)
    before = kern.LAUNCHES
    bv, bi = kern.bid_argmax(*args, 5, **kw)
    torch.cuda.synchronize()
    assert kern.LAUNCHES == before + 1
    pv, pi = kern.bid_argmax_plain(*args, 5, **kw)
    assert torch.equal(bi, pi)
    assert torch.equal(bv, pv)


@pytest.mark.cuda
@pytest.mark.parametrize("p_base,n_base", [(1000, 5000), (2**31 - 100, 2**31 - 40)])
def test_kernel_offsets(cuda, p_base, n_base):
    args = _op_inputs(3, 300, 200, cuda)
    args[7][:] = -1  # no incumbents: their ids would be global
    kw = dict(jitter=0.7, affinity_weight=0.0, num_nodes=300)
    bv, bi = kern.bid_argmax(*args, 9, p_base, n_base, **kw)
    pv, pi = kern.bid_argmax_plain(*args, 9, p_base, n_base, **kw)
    assert torch.equal(bi, pi) and torch.equal(bv, pv)


@pytest.mark.cuda
def test_kernel_tie_across_tile_boundary(cuda):
    """jitter=0, equal prices, everything below node 127 infeasible: node
    127 (last of the kernel's first tile) ties every later node and wins."""
    n, p = 600, 260
    args = _op_inputs(1, n, p, cuda)
    free, node_part, node_feat, price, dem, job_part, req_feat, inc, dem_n, free_n = args
    free[:] = 100.0
    free[:127] = 0.0
    dem[:] = 1.0
    job_part[:] = -1
    req_feat[:] = 0
    inc[:] = -1
    price[:] = 0.25
    bv, bi = kern.bid_argmax(*args, 1, jitter=0.0, affinity_weight=0.0, num_nodes=n)
    assert (bi == 127).all() and (bv == -0.25).all()


@pytest.mark.cuda
def test_kernel_rejects_bad_operands(cuda):
    args = _op_inputs(2, 50, 40, cuda)
    args[0] = args[0].cpu()
    with pytest.raises(ValueError, match="free on cpu|on cuda"):
        kern.bid_argmax(*args, 0, jitter=1.0, affinity_weight=0.0, num_nodes=50)


@pytest.mark.cuda
def test_solve_on_card_equals_cpu(cuda):
    """Kernel path, dense plain path on the card, and the CPU solve place
    identically; two card solves are identical."""
    snap, batch = random_scenario(300, 1500, seed=13, load=0.8,
                                  gpu_fraction=0.15, gang_fraction=0.05)
    cpu = auction_place(snap, batch, AuctionConfig(rounds=8, candidates=0), device="cpu")
    before = kern.LAUNCHES
    solver = DeviceSolver(snap, AuctionConfig(rounds=8))
    k1 = solver.solve(batch)
    assert kern.LAUNCHES == before + 8
    k2 = solver.solve_async(batch).result()
    dense = auction_place(snap, batch, AuctionConfig(rounds=8, use_pallas=False, candidates=0))
    np.testing.assert_array_equal(k1.node_of, k2.node_of)
    np.testing.assert_array_equal(k1.node_of, dense.node_of)
    np.testing.assert_array_equal(k1.node_of, cpu.node_of)


@pytest.mark.cuda
def test_tick_on_card_equals_cpu(cuda):
    """Two PlacementScheduler ticks with the kernel on the card bind the
    same pods, to the same nodes, with the same reasons and pressure
    ledger, as the same ticks on the CPU; each fresh solve launches the
    kernel once per round, and the CPU ticks launch it never."""
    import chip_smoke
    from slurm_bridge_tpu_torch.bridge import Pod, PlacementScheduler
    from slurm_bridge_tpu_torch.solver.snapshot import random_inventory

    partitions, nodes, demands = random_inventory(
        400, 1600, seed=3, load=0.9, gpu_fraction=0.15, gang_fraction=0.1
    )
    client, make_store = chip_smoke.port_tick_world(partitions, nodes, demands)
    runs = {}
    for device in (None, "cpu"):
        store = make_store()
        sched = PlacementScheduler(
            store, client, backend="auction", inventory_ttl=0,
            auction_config=AuctionConfig(rounds=8, candidates=0), device=device,
        )
        before = kern.LAUNCHES
        ticks = []
        for _ in range(2):
            placed = sched.tick()
            ticks.append((placed, sched.last_route, sched.last_explain_ledger,
                          chip_smoke.tick_digest(store.list(Pod.KIND))))
        runs[device] = (ticks, kern.LAUNCHES - before, sched.solves_total)
    card, cpu = runs[None], runs["cpu"]
    assert card[0] == cpu[0]
    assert card[0][0][0] > 0 and card[0][0][1] == "auction"
    assert card[1] == 8 * card[2] and card[2] == 2
    assert cpu[1] == 0


@pytest.mark.cuda
def test_tick_kernel_calls_equal_plain(cuda):
    """What the kernel returns inside a tick — on the scheduler's padded
    batch, whose pad rows (``PAD_PARTITION``) stay live every round, and
    each round's live mask — equals its plain version on the same
    operands, bit for bit."""
    import chip_smoke
    from slurm_bridge_tpu_torch.bridge import PlacementScheduler
    from slurm_bridge_tpu_torch.solver.snapshot import PAD_PARTITION, random_inventory

    partitions, nodes, demands = random_inventory(
        400, 1600, seed=3, load=0.9, gpu_fraction=0.15, gang_fraction=0.1
    )
    client, make_store = chip_smoke.port_tick_world(partitions, nodes, demands)
    sched = PlacementScheduler(
        make_store(), client, backend="auction", inventory_ttl=0,
        auction_config=AuctionConfig(rounds=8, candidates=0),
    )
    with chip_smoke.kernel_events(keep_operands=True, timed=False) as calls:
        assert sched.tick() > 0
    assert len(calls) == 8
    for r in calls:
        args, kw = r["args"], r["kw"]
        assert (args[5][r["live"]] == int(PAD_PARTITION)).any()
        pv, pi = kern.bid_argmax_plain(
            *args, r["salt"], jitter=kw["jitter"], affinity_weight=kw["affinity_weight"],
            num_nodes=kw["num_nodes"], live=r["live"],
        )
        bv, bi = r["out"]
        assert torch.equal(bi, pi)
        assert torch.equal(bv.view(torch.int32), pv.view(torch.int32))


def _kernel_vs_plain(args, salt, n, *, p_base=0, n_base=0, aw=0.0, jitter=1.0, live=None):
    kw = dict(jitter=jitter, affinity_weight=aw, num_nodes=n, live=live)
    bv, bi = kern.bid_argmax(*args, salt, p_base, n_base, **kw)
    torch.cuda.synchronize()
    pv, pi = kern.bid_argmax_plain(*args, salt, p_base, n_base, **kw)
    assert torch.equal(bi, pi)
    assert torch.equal(bv.view(torch.int32), pv.view(torch.int32))  # bits, signs of zero too
    return bv, bi


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,frac", [(700, 300, 0.5), (4099, 2100, 0.1), (33, 1000, 0.0), (1, 1, 1.0)])
@pytest.mark.parametrize("aw", [0.0, 0.3])
def test_kernel_with_live_mask(cuda, n, p, frac, aw):
    args = _op_inputs(n * 7 + p, n, p, cuda)
    live = torch.from_numpy(np.random.default_rng(p).random(p) < frac).to(cuda)
    bv, bi = _kernel_vs_plain(args, 4, n, aw=aw, live=live)
    assert (bi[~live] == n).all() and torch.isneginf(bv[~live]).all()


@pytest.mark.cuda
def test_kernel_wildcard_empty_and_unknown_partitions(cuda):
    """Rows of any partition, of a partition without nodes, of a code past
    every node's, and of the padding code, mixed in one call."""
    n, p = 1500, 2000
    args = _op_inputs(21, n, p, cuda)
    rng = np.random.default_rng(21)
    node_part = rng.integers(-1, 6, n).astype(np.int32)
    node_part[node_part == 2] = 0  # partition 2 has no nodes
    job_part = rng.choice(np.array([-1, 0, 1, 2, 3, 5, 9, 2**30], np.int32), p)
    args[1] = torch.from_numpy(node_part).to(cuda)
    args[5] = torch.from_numpy(job_part).to(cuda)
    live = torch.from_numpy(rng.random(p) < 0.8).to(cuda)
    for aw in (0.0, 0.3):
        _, bi = _kernel_vs_plain(args, 6, n, aw=aw, live=live)
    jp = torch.from_numpy(job_part).to(cuda)
    assert (bi[(jp == 2) | (jp == 9) | (jp == 2**30)] == n).all()
    assert (bi[live & (jp == -1)] < n).any()


@pytest.mark.cuda
def test_kernel_tie_across_chunks_and_partitions(cuda):
    """jitter=0, equal prices: node 150 (partition 3, late in the
    partition order) ties node 2,000 (partition 0, early in it, in another
    chunk); rows of any partition must take 150, the lower index."""
    n, p = 2500, 700
    args = _op_inputs(5, n, p, cuda)
    free, node_part, node_feat, price, dem, job_part, req_feat, inc, dem_n, free_n = args
    free[:] = 0.0
    free[150] = 100.0
    free[2000] = 100.0
    node_part[:] = torch.arange(n, device=cuda) % 4
    node_part[150], node_part[2000] = 3, 0
    dem[:] = 1.0
    job_part[:] = -1
    req_feat[:] = 0
    inc[:] = -1
    price[:] = 0.25
    bv, bi = _kernel_vs_plain(args, 1, n, jitter=0.0)
    assert (bi == 150).all() and (bv == -0.25).all()
    job_part[: p // 2] = 0  # these rows can only take node 2,000
    bv, bi = _kernel_vs_plain(args, 1, n, jitter=0.0)
    assert (bi[: p // 2] == 2000).all() and (bi[p // 2 :] == 150).all()


@pytest.mark.cuda
def test_kernel_offsets_with_live_and_incumbents(cuda):
    """Offsets near 2^31 with global incumbent ids and a live mask."""
    n, p = 900, 1300
    p_base, n_base = 2**31 - 500, 2**31 - 300
    args = _op_inputs(8, n, p, cuda)
    local = np.random.default_rng(8).integers(0, n, p)
    glob = ((local + n_base) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    pinned = np.arange(p) % 3 == 0
    args[7] = torch.from_numpy(np.where(pinned, glob, -1).astype(np.int32)).to(cuda)
    live = torch.from_numpy(np.arange(p) % 5 != 0).to(cuda)
    _, bi = _kernel_vs_plain(args, 12, n, p_base=p_base, n_base=n_base, live=live)
    got = bi.cpu().numpy()
    ok = pinned & (glob >= 0) & (got != n)  # a pin that wraps negative is no pin
    assert (got[ok] == glob[ok]).all()


@pytest.mark.cuda
def test_kernel_is_deterministic_and_runs_a_late_round(cuda):
    """Two launches give identical outputs; a late round of the headline
    shape (5,500 live rows of 57,635 on 10,000 nodes) runs and agrees."""
    snap, batch = random_scenario(10_000, 50_000, seed=42, load=0.7,
                                  gpu_fraction=0.15, gang_fraction=0.05)
    from slurm_bridge_tpu_torch.solver.auction import resource_scale, to_device

    scale = resource_scale(snap)
    args = [
        to_device(snap.free, np.float32, cuda),
        to_device(snap.partition_of, np.int32, cuda),
        to_device(snap.features, np.int32, cuda),
        to_device(np.random.default_rng(1).uniform(0, 0.5, snap.num_nodes), np.float32, cuda),
        to_device(batch.demand, np.float32, cuda),
        to_device(batch.partition_of, np.int32, cuda),
        to_device(batch.req_features, np.int32, cuda),
        to_device(np.full(batch.num_shards, -1), np.int32, cuda),
        to_device(batch.demand * scale, np.float32, cuda),
        to_device(snap.free * scale, np.float32, cuda),
    ]
    p = batch.num_shards
    live_np = np.zeros(p, bool)
    live_np[np.random.default_rng(2).choice(p, 5500, replace=False)] = True
    live = torch.from_numpy(live_np).to(cuda)
    kw = dict(jitter=1.0, affinity_weight=0.0, num_nodes=snap.num_nodes, live=live)
    a = kern.bid_argmax(*args, 5, **kw)
    b = kern.bid_argmax(*args, 5, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    _kernel_vs_plain(args, 5, snap.num_nodes, live=live)


@pytest.mark.cuda
@pytest.mark.parametrize("p,live_frac", [(57_635, 0.1), (57_635, 1.0), (3000, 0.0), (1, 1.0), (700, 0.5)])
def test_work_list_kernel_equals_plain(cuda, p, live_frac):
    """The two work-list passes against their plain version, rows of any
    partition and unknown codes included."""
    rng = np.random.default_rng(p)
    job_part = rng.choice(np.array([-1, 0, 1, 2, 3, 5, 9, 2**30], np.int32), p,
                          p=[0.05, 0.3, 0.2, 0.1, 0.2, 0.1, 0.03, 0.02])
    order = kern.row_order(torch.from_numpy(job_part).to(cuda))
    live = torch.from_numpy(rng.random(p) < live_frac).to(cuda)
    for mask in (live, None):
        got = kern.work_list(mask, order)
        want = kern.work_list_plain(mask, order)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_sim_on_card_equals_cpu(cuda):
    """The full bridge loop (operator, providers, scheduler, simulated
    agent) on full_50kx10k at scale 0.05 with the auction pinned: the
    card's run ends with the CPU's digests, its solves on the kernel."""
    import dataclasses

    from slurm_bridge_tpu_torch.sim import run_scenario
    from slurm_bridge_tpu_torch.sim.scenarios import full_50kx10k

    sc = dataclasses.replace(
        full_50kx10k(scale=0.05), backend="auction",
        auction_config=AuctionConfig(rounds=8, candidates=0),
    )
    before = kern.LAUNCHES
    card = run_scenario(sc, device="cuda")
    assert kern.LAUNCHES > before
    cpu = run_scenario(sc, device="cpu")
    for key in ("digest", "final_state_digest", "bound_total"):
        assert card.determinism[key] == cpu.determinism[key], key
    assert card.determinism["invariant_violations"] == []


_POOL_AFTER_CUDA = """
import os, sys
import torch
os.environ["SBT_COLPOOL_WORKERS"] = "2"
torch.ones(4, device="cuda").sum().item()  # the parent's CUDA context
from slurm_bridge_tpu_torch.parallel import colpool
from slurm_bridge_tpu_torch.wire import coldec, messages as pb
resp = pb.JobsInfoResponse(version=3)
for j in range(20):
    e = resp.jobs.add(job_id=j, found=True)
    e.info.add(id=j, name=f"j{j}", status=5, run_time_s=j)
blobs = [resp.SerializeToString()] * 4
pool = colpool.active_pool()
got = pool.decode_jobs_info_many(blobs)
want = colpool.decode_serial(blobs)
assert got is not None and len(got) == 4
for a, b in zip(got, want):
    assert a.jid.tolist() == b.jid.tolist() and a.state.tolist() == b.state.tolist()
colpool.reset()
print("ok")
"""


@pytest.mark.cuda
def test_forked_pool_worker_answers_after_the_parent_initialized_cuda(cuda):
    """The provider's pool forks after the tick has created the CUDA
    context; its workers touch no torch, so they answer."""
    import os
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", _POOL_AFTER_CUDA], capture_output=True, text=True,
        cwd=repo, env=dict(os.environ, PYTHONPATH=str(repo)), timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


@pytest.mark.cuda
@pytest.mark.parametrize("name,scale", [("sharded_smoke", 0.1), ("sharded_gang_split", 0.5)])
def test_sharded_sim_on_card_equals_cpu(cuda, name, scale):
    """The sharded tick with the auction pinned (several shards; the gang
    split places gangs through the cross-shard reconcile pass): every
    shard's solve launches the kernel on the card, and the run ends with
    the CPU's digests and shard statistics."""
    import dataclasses

    from slurm_bridge_tpu_torch.sim import run_scenario
    from slurm_bridge_tpu_torch.sim.scenarios import SCENARIOS

    sc = SCENARIOS[name](scale=scale)
    sc = dataclasses.replace(
        sc, backend="auction", auction_config=AuctionConfig(rounds=8, candidates=0),
        sharding=dataclasses.replace(sc.sharding, device_solve=False),
    )
    before = kern.LAUNCHES
    card = run_scenario(sc, device="cuda")
    assert kern.LAUNCHES > before
    cpu = run_scenario(sc, device="cpu")
    assert card.determinism["shard"]["shard_count"] >= 2
    for key in ("digest", "final_state_digest", "bound_total", "shard"):
        assert card.determinism[key] == cpu.determinism[key], key
    assert card.determinism["invariant_violations"] == []
    if name == "sharded_gang_split":
        assert card.determinism["shard"]["reconcile_placed"] >= 1


@pytest.mark.cuda
def test_crash_restart_on_card_equals_cpu(cuda):
    """A bridge crash and snapshot + WAL reload with the auction pinned:
    the restarted scheduler's fresh solver launches the kernel, and the
    run ends with the CPU's digests."""
    import dataclasses

    from slurm_bridge_tpu_torch.sim import run_scenario
    from slurm_bridge_tpu_torch.sim.scenarios import full_50kx10k_crash

    sc = dataclasses.replace(
        full_50kx10k_crash(scale=0.05), backend="auction",
        auction_config=AuctionConfig(rounds=8, candidates=0),
    )
    card = run_scenario(sc, device="cuda")
    cpu = run_scenario(sc, device="cpu")
    assert card.determinism["restarts"] == 1
    for key in ("digest", "final_state_digest", "bound_total", "restored_objects"):
        assert card.determinism[key] == cpu.determinism[key], key


@pytest.mark.cuda
def test_update_snapshot_rebuilds_the_node_order(cuda):
    """A shard whose partition layout changes gets the new layout's node
    order: a stale one would score rows against the wrong partitions."""
    snap_a, batch = random_scenario(600, 1500, seed=5, load=0.6)
    snap_b = random_scenario(600, 1500, seed=5, load=0.6)[0]
    snap_b.partition_of = np.roll(snap_b.partition_of, 37)
    solver = DeviceSolver(snap_a, AuctionConfig(rounds=4, candidates=0), device="cuda")
    a_nodes = [t.clone() for t in solver._dev_nodes]
    solver.update_snapshot(snap_b)
    want = kern.node_order(snap_b.partition_of, cuda)
    assert all(torch.equal(x, y) for x, y in zip(solver._dev_nodes, want))
    assert not all(torch.equal(x, y) for x, y in zip(a_nodes, want))
    got = solver.solve(batch)
    ref = DeviceSolver(snap_b, AuctionConfig(rounds=4, candidates=0), device="cpu").solve(batch)
    np.testing.assert_array_equal(got.node_of, ref.node_of)


@pytest.mark.cuda
def test_churn_tick_kernel_calls_equal_plain(cuda):
    """A streaming churn tick on the card, most of whose rows are pinned
    incumbents (each may score only the node it holds): each kernel call
    equals its plain version on its own operands, bit for bit, and the
    tick equals the same tick on the CPU."""
    import chip_smoke
    from slurm_bridge_tpu_torch.solver.streaming import churn_scenario, churn_step

    def run(device, keep):
        sim = churn_scenario(800, 3000, seed=5, load=0.7, device=device)
        sim.config = AuctionConfig(rounds=8, candidates=0)
        sim.engine = "device"
        rng = np.random.default_rng(0)
        sim.tick()
        with chip_smoke.kernel_events(keep_operands=keep, timed=False) as calls:
            res = churn_step(sim, rng, 100)
        return res, calls

    card, calls = run("cuda", True)
    cpu, _ = run("cpu", False)
    assert len(calls) == 8
    assert card.incumbent.mean() > 0.5
    for r in calls:
        kw = r["kw"]
        assert (r["args"][7] >= 0).any()
        pv, pi = kern.bid_argmax_plain(
            *r["args"], r["salt"], jitter=kw["jitter"], affinity_weight=kw["affinity_weight"],
            num_nodes=kw["num_nodes"], live=r["live"],
        )
        bv, bi = r["out"]
        assert torch.equal(bi, pi)
        assert torch.equal(bv.view(torch.int32), pv.view(torch.int32))
    assert chip_smoke.churn_summary(card) == chip_smoke.churn_summary(cpu)


@pytest.mark.cuda
def test_sidecar_place_on_card_equals_cpu(cuda):
    """The sidecar's Place on the card launches the kernel 8 times and
    answers the bytes the CPU's servicer answers; SolverInfo reports the
    card."""
    import chip_smoke
    from slurm_bridge_tpu_torch.solver.service import PlacementSolverServicer
    from slurm_bridge_tpu_torch.solver.snapshot import random_inventory
    from slurm_bridge_tpu_torch.wire import convert, pb
    from slurm_bridge_tpu_torch.wire.rpc import LocalContext

    partitions, nodes, demands = random_inventory(300, 1200, seed=42, load=0.7)
    request = chip_smoke.place_request(pb, convert, partitions, nodes, demands)
    cfg = AuctionConfig(rounds=8, candidates=0)
    card_sv = PlacementSolverServicer(cfg)
    before = kern.LAUNCHES
    card = card_sv.Place(request, LocalContext())
    assert kern.LAUNCHES - before == 8
    cpu = PlacementSolverServicer(cfg, device="cpu").Place(request, LocalContext())
    assert chip_smoke.response_digest(pb, card) == chip_smoke.response_digest(pb, cpu)
    info = card_sv.SolverInfo(pb.SolverInfoRequest(), LocalContext())
    assert (info.backend, info.devices) == ("cuda", torch.cuda.device_count())


@pytest.mark.cuda
def test_sweep_on_card_blocks_equals_cpu(cuda):
    """The multi-device sweep on a 2×2 grid of ``cuda:0`` blocks: four
    kernel launches per round, each block with its global offsets, and the
    placement of the same sweep on CPU blocks (the dense block path) and
    of the single-block solve; deterministic."""
    from slurm_bridge_tpu_torch.parallel.mesh import solver_mesh
    from slurm_bridge_tpu_torch.solver.sharded import sharded_place

    snap, batch = random_scenario(301, 1500, seed=13, load=0.8,
                                  gpu_fraction=0.15, gang_fraction=0.05)
    cfg = AuctionConfig(rounds=8, candidates=0)
    grid = solver_mesh([cuda] * 4, dp=2, mp=2)
    before = kern.LAUNCHES
    card = sharded_place(snap, batch, cfg, mesh=grid)
    assert kern.LAUNCHES - before == 8 * 4
    again = sharded_place(snap, batch, cfg, mesh=grid)
    cpu_grid = solver_mesh([torch.device("cpu")] * 4, dp=2, mp=2)
    cpu = sharded_place(snap, batch, cfg, mesh=cpu_grid, device="cpu")
    single = auction_place(snap, batch, cfg, device="cpu")
    np.testing.assert_array_equal(card.node_of, again.node_of)
    np.testing.assert_array_equal(card.node_of, cpu.node_of)
    np.testing.assert_array_equal(card.free_after, cpu.free_after)
    np.testing.assert_array_equal(card.node_of, single.node_of)
