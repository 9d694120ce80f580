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
from slurm_bridge_tpu_torch.ops.bid_argmax import (
    affinity_fma, bid_argmax, bid_argmax_plain, fma_f32, mix, node_order, row_order,
    tile_ranges, unit, work_list,
)
from tests.test_ops import _random_op_inputs, _reference

@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in parallel workers, and torch
    on every core in each starves the timing-sensitive tests beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


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


@pytest.mark.parametrize(
    "n,p,frac,p_base", [(700, 300, 0.5, 0), (33, 1000, 0.1, 0), (512, 256, 1.0, 0),
                        (50, 40, 0.0, 0), (90, 70, 0.4, 2**31 - 30)],
)
def test_plain_live_rows_equal_jax(n, p, frac, p_base):
    """With a live mask the live rows get the JAX kernel's answer (its
    rows are all scored) and the others (−inf, num_nodes)."""
    inp = _random_op_inputs(seed=n + p, n=n, p=p)
    live = np.random.default_rng(p).random(p) < frac
    bv, bi = bid_argmax(
        *_port_args(inp), 7, p_base, jitter=1.0, affinity_weight=0.0, num_nodes=n,
        live=torch.from_numpy(live),
    )
    jv, ji = _jax(inp, 7, jitter=1.0, aw=0.0, n=n, p_base=p_base)
    np.testing.assert_array_equal(bi.numpy()[live], ji[live])
    np.testing.assert_array_equal(bv.numpy()[live], jv[live])
    assert (bi.numpy()[~live] == n).all()
    assert np.isneginf(bv.numpy()[~live]).all()


def test_live_none_is_all_live():
    inp = _random_op_inputs(seed=4, n=100, p=90)
    args = _port_args(inp)
    kw = dict(jitter=1.0, affinity_weight=0.3, num_nodes=100)
    a = bid_argmax_plain(*args, 2, **kw)
    b = bid_argmax_plain(*args, 2, **kw, live=torch.ones(90, dtype=torch.bool))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _work_case(seed, n, p, live_frac, wild=0.1, k=5):
    """Random node and row partitions: codes 0..k-1 with partition 1 given
    no nodes, some nodes of no partition (−1), rows of any partition (−1),
    rows of a code past the offsets (k + 2) and of the padding code 2^30."""
    rng = np.random.default_rng(seed)
    node_part = rng.integers(-1, k, n).astype(np.int32)
    node_part[node_part == 1] = 0
    codes = np.array([-1, 0, 1, 2, 3, k - 1, k + 2, 2**30], np.int32)
    weights = np.array([wild, 0.2, 0.1, 0.2, 0.2, 0.1, 0.05, 0.05])
    job_part = rng.choice(codes, p, p=weights / weights.sum()).astype(np.int32)
    live = rng.random(p) < live_frac
    return node_part, job_part, live


@pytest.mark.parametrize(
    "seed,n,p,live_frac,wild,tile",
    [
        (1, 60, 200, 0.6, 0.1, 8),  # mixed, many tiles straddling partitions
        (2, 60, 200, 0.0, 0.1, 8),  # an all-dead round
        (3, 40, 150, 1.0, 0.0, 16),  # no wildcard rows
        (4, 40, 150, 0.5, 1.0, 16),  # only wildcard rows
        (5, 25, 9, 0.7, 0.1, 3),  # ragged last tile
        (6, 30, 1, 1.0, 0.1, 512),  # one row, one tile
        (7, 300, 1000, 0.3, 0.05, 512),  # the kernel's tile size
    ],
)
def test_work_list_against_brute_force(seed, n, p, live_frac, wild, tile):
    """Every live row once, in partition order; dead slots −1; each tile's
    node range holds every node any of its rows could take; tiles past the
    live count walk nothing."""
    node_part, job_part, live = _work_case(seed, n, p, live_frac, wild)
    order, offsets = node_order(node_part, "cpu")
    order_np = order.numpy()
    assert sorted(order_np.tolist()) == list(range(n))
    runs = node_part[order_np]
    assert (np.diff(runs) >= 0).all()  # grouped by partition, ascending
    for q in range(offsets.shape[0] - 1):
        run = order_np[offsets[q] : offsets[q + 1]]
        assert (node_part[run] == q).all() and (np.diff(run) > 0).all()
    jp = torch.from_numpy(job_part)
    rows_c, count = work_list(torch.from_numpy(live), row_order(jp))
    lo, hi = tile_ranges(rows_c, count, jp, offsets, n, tile)
    want = [r for r in np.argsort(job_part, kind="stable") if live[r]]
    cnt = int(count[0])
    assert cnt == len(want) == int(live.sum())
    assert rows_c[:cnt].tolist() == want
    assert (rows_c[cnt:] == -1).all()
    assert lo.shape[0] == -(-p // tile)
    for t in range(lo.shape[0]):
        members = want[t * tile : (t + 1) * tile]
        if not members:
            assert lo[t] == hi[t] == 0
            continue
        span = set(order_np[lo[t] : hi[t]].tolist())
        for r in members:
            jp = job_part[r]
            could = np.nonzero((node_part == jp) | (jp < 0))[0]
            assert set(could.tolist()) <= span
        if job_part[members[0]] >= 0:  # no wildcard row: no node outside
            lo_p, hi_p = job_part[members[0]], job_part[members[-1]]
            assert all(lo_p <= node_part[v] <= hi_p for v in span)


def test_work_list_without_live_mask():
    node_part, job_part, _ = _work_case(8, 50, 70, 1.0)
    order, offsets = node_order(torch.from_numpy(node_part), "cpu")
    jp = torch.from_numpy(job_part)
    a = work_list(None, row_order(jp))
    b = work_list(torch.ones(70, dtype=torch.bool), row_order(jp))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(a[1][0]) == 70
    ra = tile_ranges(*a, jp, offsets, 50, 16)
    rb = tile_ranges(*b, jp, offsets, 50, 16)
    assert all(torch.equal(x, y) for x, y in zip(ra, rb))


def _dense_values(args, salt, *, jitter, aw):
    """where(ok, bid, −inf) over every (row, node), in the plain version's
    own arithmetic."""
    free, node_part, node_feat, price, dem, job_part, req_feat, inc, dem_n, free_n = args
    p, n = dem.shape[0], free.shape[0]
    rf = req_feat[:, None].long() & 0xFFFFFFFF
    ok = (job_part[:, None] == node_part[None, :]) | (job_part[:, None] < 0)
    ok &= ((node_feat[None, :].long() & 0xFFFFFFFF) & rf) == rf
    for r in range(3):
        ok &= dem[:, r : r + 1] <= (free + 1e-6)[None, :, r]
    ok &= (inc[:, None] < 0) | (torch.arange(n)[None, :] == inc[:, None])
    jit = unit(mix(torch.arange(p)[:, None], torch.arange(n)[None, :], salt))
    if aw:
        aff = affinity_fma(dem_n[:, None, :], free_n[None, :, :])
        bid = fma_f32(jit, jitter, aw * -aff) - price[None, :]
    else:
        bid = jit * jitter - price[None, :]
    return torch.where(ok, bid, float("-inf"))


@pytest.mark.parametrize("aw", [0.0, 0.3])
def test_kernel_schedule_emulated_equals_plain(aw):
    """The kernel's schedule run on the CPU: rows only from the work list,
    each tile over its node range cut into chunks, each chunk's best per row
    merged by (value, lowest index) — the same answer as the dense plain
    version. Ties are forced (jitter 0 for half the nodes' prices) so the
    merge's index rule is exercised across chunks and partitions."""
    n, p, tile, chunk = 90, 130, 8, 7
    node_part, job_part, live = _work_case(11, n, p, 0.7)
    inp = _random_op_inputs(seed=11, n=n, p=p)
    inp["node_part"], inp["job_part"] = node_part, job_part
    inp["free"][:] = 60.0
    inp["price"][::2] = 0.5
    args = _port_args(inp)
    values = _dense_values(args, 3, jitter=0.0, aw=aw)
    order, offsets = node_order(node_part, "cpu")
    rows_c, count = work_list(torch.from_numpy(live), row_order(args[5]))
    lo, hi = tile_ranges(rows_c, count, args[5], offsets, n, tile)
    best = torch.full((p,), float("-inf"))
    choice = torch.full((p,), n, dtype=torch.int32)
    for t in range(lo.shape[0]):
        members = rows_c[t * tile : min((t + 1) * tile, int(count[0]))].long()
        for c0 in range(int(lo[t]), int(hi[t]), chunk):
            nodes = order[c0 : min(c0 + chunk, int(hi[t]))].long()
            for r in members.tolist():
                for v in nodes.tolist():
                    x = values[r, v]
                    if x > float("-inf") and (x > best[r] or (x == best[r] and v < choice[r])):
                        best[r], choice[r] = x, v
    pv, pi = bid_argmax_plain(
        *args, 3, jitter=0.0, affinity_weight=aw, num_nodes=n, live=torch.from_numpy(live)
    )
    assert torch.equal(choice, pi) and torch.equal(best, pv)
    assert (pi[torch.from_numpy(live)] < n).any()  # some live rows placed
