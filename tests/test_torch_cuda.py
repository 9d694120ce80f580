"""Card-only tests: the CUDA kernel against its plain version, and the
solve on the card against the same solve on the CPU.

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
