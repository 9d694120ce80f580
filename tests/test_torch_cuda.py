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
