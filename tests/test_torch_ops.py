"""The port's bid_argmax against the JAX package's, on the CPU.

On a CPU tensor the port's wrapper runs its plain version (the kernel's
tiling, padding, offsets and sentinel in PyTorch ops); the JAX side runs
the Pallas kernel in interpret mode, as tests/test_ops.py does. The same
numpy inputs go to both. The CUDA kernel itself is held against the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slurm_bridge_tpu.ops.bid_argmax import bid_argmax as jax_bid_argmax
import slurm_bridge_tpu_torch.ops.bid_argmax as ops_mod
from slurm_bridge_tpu_torch.ops.bid_argmax import bid_argmax, bid_argmax_plain
from tests.test_ops import _random_op_inputs, _reference

_ORDER = (
    "free", "node_part", "node_feat", "price", "dem", "job_part", "req_feat",
    "incumbent", "dem_n", "free_n",
)


def _port_args(inp, device="cpu"):
    """numpy op inputs → the port's tensors (uint32 masks as int32 bits)."""
    out = []
    for k in _ORDER:
        a = np.ascontiguousarray(inp[k])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out.append(torch.from_numpy(a.copy()).to(device))
    return out


def _jax(inp, salt, *, jitter, aw, n, p_base=0, n_base=0):
    bv, bi = jax_bid_argmax(
        *[jnp.asarray(inp[k]) for k in _ORDER], salt, p_base, n_base,
        jitter=jitter, affinity_weight=aw, num_nodes=n, interpret=True,
    )
    return np.asarray(bv), np.asarray(bi)


@pytest.mark.parametrize("n,p", [(700, 300), (512, 256), (33, 1000), (1, 1)])
def test_bid_argmax_bit_exact_with_jax(n, p):
    """affinity_weight=0: choices and values equal bit for bit — against
    the Pallas kernel (interpret mode) and the numpy reference."""
    inp = _random_op_inputs(seed=n * 1000 + p, n=n, p=p)
    bv, bi = bid_argmax(*_port_args(inp), 7, jitter=1.0, affinity_weight=0.0, num_nodes=n)
    jv, ji = _jax(inp, 7, jitter=1.0, aw=0.0, n=n)
    np.testing.assert_array_equal(bi.numpy(), ji)
    np.testing.assert_array_equal(bv.numpy(), jv)  # −inf rows included
    ref_v, ref_i = _reference(inp, n, 7, jitter=1.0, aw=0.0)
    np.testing.assert_array_equal(bi.numpy(), ref_i)
    feas = np.isfinite(ref_v)
    np.testing.assert_array_equal(bv.numpy()[feas], ref_v[feas])


def test_bid_argmax_bit_exact_at_other_jitter():
    """The f32 scale of the jitter is rounded alike on both sides."""
    inp = _random_op_inputs(seed=5, n=300, p=200)
    bv, bi = bid_argmax(*_port_args(inp), 11, jitter=0.7, affinity_weight=0.0, num_nodes=300)
    jv, ji = _jax(inp, 11, jitter=0.7, aw=0.0, n=300)
    np.testing.assert_array_equal(bi.numpy(), ji)
    np.testing.assert_array_equal(bv.numpy(), jv)


def test_bid_argmax_with_affinity():
    """At affinity_weight=0.3 the affinity term is summed in another order
    than the reference's matmul: values agree to atol 1e-5 and ≥ 99.9 % of
    choices agree (tests/test_ops.py's own tolerance)."""
    inp = _random_op_inputs(seed=42, n=600, p=400)
    bv, bi = bid_argmax(*_port_args(inp), 3, jitter=1.0, affinity_weight=0.3, num_nodes=600)
    jv, ji = _jax(inp, 3, jitter=1.0, aw=0.3, n=600)
    assert (bi.numpy() == ji).mean() >= 0.999
    feas = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(bv.numpy()), feas)
    np.testing.assert_allclose(bv.numpy()[feas], jv[feas], atol=1e-5)
    ref_v, ref_i = _reference(inp, 600, 3, jitter=1.0, aw=0.3)
    assert (bi.numpy() == ref_i).mean() >= 0.999


@pytest.mark.parametrize(
    "p_base,n_base",
    [(1000, 5000), (2**31 - 100, 3), (7, 2**31 - 40), (-5, -300)],
)
def test_bid_argmax_global_offsets(p_base, n_base):
    """p_base/n_base address the global hash field; offsets near 2^31 wrap
    in uint32 exactly as the Pallas kernel's int32 arithmetic does."""
    n, p = 90, 70
    inp = _random_op_inputs(seed=abs(p_base) % 97 + 1, n=n, p=p)
    # incumbents are global node ids (int32, wrapped) under an offset block;
    # one that wraps negative reads as "no incumbent" on both sides
    inc = inp["incumbent"].astype(np.int64)
    glob = ((inc + n_base) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    inp["incumbent"] = np.where(inc >= 0, glob, -1).astype(np.int32)
    bv, bi = bid_argmax(
        *_port_args(inp), 9, p_base, n_base, jitter=1.0, affinity_weight=0.0, num_nodes=n
    )
    jv, ji = _jax(inp, 9, jitter=1.0, aw=0.0, n=n, p_base=p_base, n_base=n_base)
    np.testing.assert_array_equal(bi.numpy(), ji)
    np.testing.assert_array_equal(bv.numpy(), jv)


def _tie_inputs(n, p):
    """jitter=0 and equal prices: every feasible node bids the same."""
    inp = _random_op_inputs(seed=3, n=n, p=p)
    inp["free"][:] = 100.0
    inp["dem"][:] = 1.0
    inp["job_part"][:] = -1
    inp["req_feat"][:] = 0
    inp["incumbent"][:] = -1
    inp["price"][:] = 0.25
    return inp


@pytest.mark.parametrize("bn", [2048, 64])
def test_bid_argmax_ties_go_to_lowest_node(bn):
    """An equal-value tie inside one tile, and one across a tile boundary:
    nodes below the winner are made infeasible, so the tie is between the
    winner and later nodes of the same and of the next tile."""
    n, p = 200, 5
    inp = _tie_inputs(n, p)
    inp["free"][:10] = 0.0  # nodes 0..9 infeasible
    bv, bi = bid_argmax_plain(
        *_port_args(inp), 1, jitter=0.0, affinity_weight=0.0, num_nodes=n, bp=4, bn=bn
    )
    assert (bi.numpy() == 10).all()
    assert (bv.numpy() == -0.25).all()
    # across a boundary: the first tile [0, 64) entirely infeasible but one
    # node, which ties with every node of the later tiles
    inp["free"][:64] = 0.0
    inp["free"][63] = 100.0
    bv, bi = bid_argmax_plain(
        *_port_args(inp), 1, jitter=0.0, affinity_weight=0.0, num_nodes=n, bp=4, bn=64
    )
    assert (bi.numpy() == 63).all()
    jv, ji = _jax(inp, 1, jitter=0.0, aw=0.0, n=n)
    np.testing.assert_array_equal(bi.numpy(), ji)


def test_bid_argmax_incumbent_pinning():
    """A pinned shard can choose only its own node (or nothing)."""
    inp = _random_op_inputs(seed=8, n=300, p=400)
    inp["incumbent"][:] = np.where(np.arange(400) % 2 == 0, np.arange(400) % 300, -1)
    bv, bi = bid_argmax(*_port_args(inp), 2, jitter=1.0, affinity_weight=0.0, num_nodes=300)
    pinned = inp["incumbent"] >= 0
    got = bi.numpy()[pinned]
    assert np.all((got == inp["incumbent"][pinned]) | (got == 300))
    jv, ji = _jax(inp, 2, jitter=1.0, aw=0.0, n=300)
    np.testing.assert_array_equal(bi.numpy(), ji)


def test_plain_tiling_does_not_change_the_answer():
    """The tile shape is a schedule, not a semantics: small tiles (ragged
    edges, many cross-tile merges) give the same values and choices."""
    inp = _random_op_inputs(seed=12, n=517, p=333)
    args = _port_args(inp)
    a = bid_argmax_plain(*args, 4, jitter=1.0, affinity_weight=0.3, num_nodes=517)
    b = bid_argmax_plain(*args, 4, jitter=1.0, affinity_weight=0.3, num_nodes=517, bp=7, bn=33)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_wrapper_checks_and_counts_only_launches():
    inp = _random_op_inputs(seed=1, n=20, p=10)
    args = _port_args(inp)
    before = ops_mod.LAUNCHES
    bid_argmax(*args, 0, jitter=1.0, affinity_weight=0.0, num_nodes=20)
    assert ops_mod.LAUNCHES == before  # the CPU runs the plain version
    bad = list(args)
    bad[0] = bad[0].double()
    with pytest.raises(TypeError, match="free"):
        bid_argmax(*bad, 0, jitter=1.0, affinity_weight=0.0, num_nodes=20)
    bad = list(args)
    bad[3] = bad[3][:5]
    with pytest.raises(ValueError, match="price"):
        bid_argmax(*bad, 0, jitter=1.0, affinity_weight=0.0, num_nodes=20)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        bid_argmax(*meta, 0, jitter=1.0, affinity_weight=0.0, num_nodes=20)
