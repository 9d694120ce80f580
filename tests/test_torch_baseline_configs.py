"""The BASELINE configs the card had not solved — #2 (5,000 pods on 512
nodes) and #4 (gang MPI jobsets with a best-fit affinity of 0.05), dense
and through the sampled auction path (K=64) — against the JAX package on
the CPU, and the rounding of the affinity bid that they depend on.

The reference's dense round runs on the CPU, where XLA fuses a multiply
into the add after it: its affinity is the chain ``fma(d2, f2, fma(d1, f1,
d0·f0))`` and its bid ``fma(hash, jitter, w·(−aff)) − price``; its sampled
round fuses ``hash·jitter − price`` and ``+ w·aff`` too. The port's plain
version, dense path and sampled path (and the kernel, held to the plain
version on the card) round the same way, with ``fma_f32`` for each fused
step. These tests hold every value bit for bit: against the expressions
run through ``jax.jit``, and against the values the reference's own solve
computes round by round.
"""

from fractions import Fraction
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slurm_bridge_tpu.solver.auction as ja
import slurm_bridge_tpu_torch.solver.auction as ta
from slurm_bridge_tpu.solver.snapshot import random_scenario
from slurm_bridge_tpu_torch.ops.bid_argmax import bid_argmax_plain, fma_f32
from slurm_bridge_tpu_torch.solver.convert import batch_from, config_from, snapshot_from
from tests.test_solver import _check_feasible


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in parallel workers, and torch
    on every core in each starves the timing-sensitive tests beside it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


T = torch.from_numpy

#: BASELINE config #4's shape (``benchmarks/scenarios/__init__.py``
#: ``scenario_4``) and solve config, and config #2's.
CONFIG4 = dict(seed=4, load=0.8, gang_fraction=0.5, gang_size=8)
CONFIG4_SOLVE = dict(rounds=16, gang_salvage_rounds=8, gang_first=True, affinity_weight=0.05)
CONFIG2 = dict(seed=2, load=0.7)
CONFIG2_SOLVE = dict(rounds=8)


def _f32_exact(x: Fraction) -> np.float32:
    """``x`` correctly rounded to float32 (ties to even): the reference a
    fused multiply-add is held to."""
    if x == 0:
        return np.float32(0.0)
    a = abs(x)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    while Fraction(2) ** e > a:
        e -= 1
    while Fraction(2) ** (e + 1) <= a:
        e += 1
    e = max(e, -126)  # subnormal results keep the smallest exponent's ulp
    m = round(a / Fraction(2) ** (e - 23))  # Fraction rounds half to even
    return np.float32((1 if x > 0 else -1) * m * 2.0 ** (e - 23))


def _fma_exact(a, b, c) -> np.float32:
    return _f32_exact(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def test_fma_f32_rounds_once_where_float64_rounds_twice():
    """a·b + c = 1 + 2^-23 + 2^-24 − 2^-70: float64 rounds it onto the
    float32 halfway point 1 + 2^-23 + 2^-24, whose tie goes up to
    1 + 2^-22; rounded once it is 1 + 2^-23."""
    a = np.float32(2.0**-24 * (1 - 2.0**-23))
    b = c = np.float32(1 + 2.0**-23)
    want = _fma_exact(a, b, c)
    assert want == np.float32(1 + 2.0**-23)
    twice = np.float32(np.float64(a) * np.float64(b) + np.float64(c))
    assert twice != want  # the double rounding fma_f32 must avoid
    got = fma_f32(T(np.array([a])), T(np.array([b])), T(np.array([c])))
    assert got.numpy()[0] == want


def test_fma_f32_is_correctly_rounded():
    """Random operands across exponents, near-cancellations (c ≈ −a·b),
    results in float32's subnormal range and signed zeros: every result
    is the exact a·b + c rounded once to float32, bit for bit."""
    rng = np.random.default_rng(0)
    k = 3000
    x = rng.standard_normal((3, k)).astype(np.float32)
    x *= np.float32(2.0) ** rng.integers(-40, 40, (3, k)).astype(np.float32)
    near = rng.random(k) < 0.4
    x[2, near] = -(x[0, near].astype(np.float64) * x[1, near]).astype(np.float32)
    tiny = rng.random(k) < 0.1
    x[0, tiny] *= np.float32(2.0**-60)
    x[1, tiny] *= np.float32(2.0**-60)
    x[2, tiny] = np.float32(2.0**-140) * rng.standard_normal(int(tiny.sum())).astype(np.float32)
    x = np.concatenate([x, np.array([[0.0, -0.0, 1.0, -1.0], [1.0, 1.0, -1.0, 1.0],
                                     [-0.0, -0.0, 1.0, 1.0]], np.float32)], axis=1)
    got = fma_f32(T(x[0]), T(x[1]), T(x[2])).numpy()
    want = np.array([_fma_exact(*x[:, i]) for i in range(x.shape[1])], np.float32)
    want[-4:] = [0.0, -0.0, 0.0, 0.0]  # IEEE signs of exact zeros (−0 only for −0 + −0)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _round_operands(n, jobs, price_seed=0):
    """One round's operands of a config-#4-shaped solve: the scenario's
    free capacity, a seeded price, the batch's demands, no incumbents —
    as numpy (the JAX side) and as the port's CPU tensors."""
    snap, batch = random_scenario(n, jobs, **CONFIG4)
    p = batch.num_shards
    scale = ta.resource_scale(snap)
    price = np.random.default_rng(price_seed).uniform(0, 0.5, n).astype(np.float32)
    ops = dict(
        free=snap.free.astype(np.float32), price=price, dem=batch.demand.astype(np.float32),
        job_part=batch.partition_of.astype(np.int32),
        req_feat=batch.req_features.astype(np.uint32),
        node_part=snap.partition_of.astype(np.int32), node_feat=snap.features.astype(np.uint32),
        incumbent=np.full(p, -1, np.int32), scale=scale,
    )
    ops["dem_n"] = (ops["dem"] * scale).astype(np.float32)
    t = {k: T(np.ascontiguousarray(v.view(np.int32) if v.dtype == np.uint32 else v))
         for k, v in ops.items()}
    return snap, batch, ops, t


@partial(jax.jit, static_argnames=("rnd", "jitter", "w"))
def _reference_dense_round(free, price, dem, dem_n, job_part, req_feat, node_part,
                           node_feat, scale, *, rnd, jitter, w):
    """The reference's dense score/choose (``slurm_bridge_tpu/solver/
    auction.py:468-486``, no incumbents) through ``jax.jit``."""
    p, n = dem.shape[0], free.shape[0]
    part_ok = (job_part[:, None] == node_part[None, :]) | (job_part[:, None] < 0)
    feat_ok = (node_feat[None, :] & req_feat[:, None]) == req_feat[:, None]
    free_n = free * scale
    cap_ok = jnp.all(dem[:, None, :] <= free[None, :, :] + 1e-6, axis=-1)
    feasible = part_ok & feat_ok & cap_ok
    affinity = -(dem_n @ free_n.T)
    jit_mat = ja.hash_jitter(p, n, rnd, jnp.float32) * jnp.asarray(jitter, jnp.float32)
    bid = jnp.asarray(w, jnp.float32) * affinity + jit_mat - price[None, :]
    bid = jnp.where(feasible, bid, -jnp.inf)
    choice = jnp.argmax(bid, axis=1).astype(jnp.int32)
    return choice, jnp.take_along_axis(bid, choice[:, None], axis=1)[:, 0]


@pytest.mark.parametrize("jitter", [1.0, 0.7])
@pytest.mark.parametrize("w", [0.05, 0.3])
def test_affinity_bid_equals_the_reference_round(w, jitter):
    """One round of a config-#4-shaped solve (4,042 rows × 2,000 nodes):
    ``bid_argmax_plain`` (the kernel's arithmetic), ``dense_score_choose``
    and the reference's dense round give the same values and choices, bit
    for bit. Before the plain version took the reference's fused rounding
    (``(hash·jitter − price) + w·(−aff)`` over separately rounded products)
    its best value differed from the dense path's in some rows of every
    such round."""
    n, rnd = 2000, 5
    snap, batch, ops, t = _round_operands(n, 880)
    p = batch.num_shards
    j_choice, j_best = _reference_dense_round(
        *[jnp.asarray(ops[k]) for k in ("free", "price", "dem", "dem_n", "job_part",
                                        "req_feat", "node_part", "node_feat", "scale")],
        rnd=rnd, jitter=jitter, w=w)
    j_choice, j_best = np.asarray(j_choice), np.asarray(j_best)
    d_choice, d_best = ta.dense_score_choose(
        t["free"], t["price"], t["dem"], t["dem_n"], t["job_part"], t["req_feat"],
        t["node_part"], t["node_feat"], t["incumbent"], rnd,
        jitter=jitter, affinity_weight=w, dtype=torch.float32, scale=t["scale"])
    k_best, k_choice = bid_argmax_plain(
        t["free"], t["node_part"], t["node_feat"], t["price"], t["dem"], t["job_part"],
        t["req_feat"], t["incumbent"], t["dem"] * t["scale"], t["free"] * t["scale"], rnd,
        jitter=jitter, affinity_weight=w, num_nodes=n)
    feas = np.isfinite(j_best)
    assert feas.sum() > p // 2
    for best in (d_best.numpy(), k_best.numpy()):
        np.testing.assert_array_equal(best.view(np.int32), j_best.view(np.int32))
    np.testing.assert_array_equal(d_choice.numpy()[feas], j_choice[feas])
    np.testing.assert_array_equal(k_choice.numpy()[feas], j_choice[feas])
    assert (k_choice.numpy()[~feas] == n).all()


@pytest.mark.parametrize("jitter", [1.0, 0.7])
@pytest.mark.parametrize("w", [0.0, 0.05, 0.3])
def test_sampled_values_equal_the_reference(w, jitter):
    """The sampled score/choose (K=64) on one round's operands: the port's
    values and choices equal the JAX package's ``sampled_score_choose``
    through ``jax.jit``, bit for bit — at ``w=0`` too, where the reference
    fuses ``hash·jitter − price`` (a difference only at ``jitter ≠ 1``)."""
    n, rnd, k = 2000, 3, 64
    snap, batch, ops, t = _round_operands(n, 880, price_seed=1)
    pools = ta.CandidatePools(snapshot_from(snap))
    start, count = pools.slices(batch_from(batch))
    order = pools.array
    check = ta.batch_needs_feat_check(batch.req_features)
    kw = dict(candidates=k, jitter=jitter, affinity_weight=w, dtype=jnp.float32, check_feats=check)
    ref = jax.jit(partial(ja.sampled_score_choose, **kw))
    j_choice, j_best = ref(
        *[jnp.asarray(ops[x]) for x in ("free", "price", "dem", "dem_n", "job_part", "req_feat",
                                        "node_part", "node_feat", "incumbent")],
        jnp.asarray(order), jnp.asarray(start), jnp.asarray(count), rnd,
        scale=jnp.asarray(ops["scale"]))
    choice, best = ta.sampled_score_choose(
        t["free"], t["price"], t["dem"], t["dem_n"], t["job_part"], t["req_feat"],
        t["node_part"], t["node_feat"], t["incumbent"], T(order), T(start), T(count), rnd,
        candidates=k, jitter=jitter, affinity_weight=w, dtype=torch.float32,
        scale=t["scale"], check_feats=check)
    j_best = np.asarray(j_best)
    np.testing.assert_array_equal(best.numpy().view(np.int32), j_best.view(np.int32))
    np.testing.assert_array_equal(choice.numpy(), np.asarray(j_choice))
    assert np.isfinite(j_best).sum() > batch.num_shards // 2


def _reference_rounds(monkeypatch, snap, batch, cfg):
    """The JAX package's ``auction_place`` with each round's best value per
    row (what its score/choose takes along its argmax), price and free
    capacity read out of its jitted loop. Its cache is cleared before and
    after, so the read-out is traced into this solve alone."""
    best, state = [], []
    real_take = jnp.take_along_axis
    real_price_step = ja.price_step

    def take(a, idx, axis=None, **kw):
        out = real_take(a, idx, axis=axis, **kw)
        if jnp.issubdtype(a.dtype, jnp.floating):
            jax.debug.callback(lambda x: best.append(np.array(x).reshape(-1)), out, ordered=True)
        return out

    def price_step(price, choice, valid, dem_n, free, scale, n, eta):
        jax.debug.callback(lambda a, b: state.append((np.array(a), np.array(b))), price, free,
                           ordered=True)
        return real_price_step(price, choice, valid, dem_n, free, scale, n, eta)

    monkeypatch.setattr(jnp, "take_along_axis", take)
    monkeypatch.setattr(ja, "price_step", price_step)
    jax.clear_caches()
    try:
        ja.auction_place(snap, batch, cfg)
        jax.effects_barrier()
    finally:
        jax.clear_caches()
    assert len(best) == len(state) == cfg.rounds
    return best, state


@pytest.mark.parametrize("candidates", [0, 64])
def test_rounds_equal_the_reference_solves_own(monkeypatch, candidates):
    """The reference's own solve (config #4's knobs at jitter 0.7, 600
    nodes): on each round's price and free capacity, read out of its loop,
    the port's dense (or sampled) score/choose gives the best value the
    reference's round gave, bit for bit, for every row."""
    snap, batch = random_scenario(600, 700, **CONFIG4)
    cfg = ja.AuctionConfig(**dict(CONFIG4_SOLVE, rounds=4, gang_salvage_rounds=2), jitter=0.7,
                           candidates=candidates, use_pallas=False, repair=False)
    best, state = _reference_rounds(monkeypatch, snap, batch, cfg)
    s, b = snapshot_from(snap), batch_from(batch)
    scale = T(ta.resource_scale(s))
    q = ta.stage_batch(b, np.full(b.num_shards, -1, np.int32), "cpu")
    dem_n = q["dem"] * scale
    node = dict(node_part=T(s.partition_of.astype(np.int32)),
                node_feat=T(ta.bits_i32(s.features)))
    if candidates:
        pools = ta.CandidatePools(s)
        start, count = (T(a) for a in pools.slices(b))
        order = T(pools.array)
    for rnd, (want, (price, free)) in enumerate(zip(best, state)):
        price, free = T(price.copy()), T(free.copy())
        kw = dict(jitter=cfg.jitter, affinity_weight=cfg.affinity_weight,
                  dtype=torch.float32, scale=scale)
        if candidates:
            _, got = ta.sampled_score_choose(
                free, price, q["dem"], dem_n, q["job_part"], q["req_feat"], node["node_part"],
                node["node_feat"], q["incumbent"], order, start, count, rnd,
                candidates=candidates, check_feats=ta.batch_needs_feat_check(b.req_features),
                **kw)
        else:
            _, got = ta.dense_score_choose(
                free, price, q["dem"], dem_n, q["job_part"], q["req_feat"], node["node_part"],
                node["node_feat"], q["incumbent"], rnd, **kw)
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32),
                                      err_msg=f"round {rnd}")


_SOLVES = {
    "config4": ((400, 500), CONFIG4, CONFIG4_SOLVE),
    "config4-jitter0.7": ((400, 500), CONFIG4, dict(CONFIG4_SOLVE, jitter=0.7)),
    "config2": ((512, 5000), CONFIG2, CONFIG2_SOLVE),
}


@pytest.mark.parametrize("candidates", [0, 64])
@pytest.mark.parametrize("name", sorted(_SOLVES))
def test_baseline_config_solve_equals_the_jax_package(name, candidates):
    """A config-#4-shaped solve (16 rounds, 8 salvage rounds, gang-first,
    affinity 0.05; at jitter 1.0 and 0.7) and config #2 at its full size,
    each dense and sampled (K=64), pinned alike on both sides: the port's
    ``node_of`` equals the JAX package's — through the dense branch and,
    for the dense solve, through the kernel's wrapper (its plain version
    on the CPU)."""
    (n, jobs), shape, solve = _SOLVES[name]
    snap, batch = random_scenario(n, jobs, **shape)
    cfg = ja.AuctionConfig(**solve, candidates=candidates, use_pallas=False)
    want = ja.auction_place(snap, batch, cfg)
    s, b = snapshot_from(snap), batch_from(batch)
    got = ta.auction_place(s, b, config_from(cfg), device="cpu")
    np.testing.assert_array_equal(got.node_of, want.node_of)
    _check_feasible(snap, batch, got)
    assert got.placed.sum() > batch.num_shards // 2
    if candidates == 0:
        kern = ta.auction_place(s, b, ta.AuctionConfig(**solve, candidates=0, use_pallas=True),
                                device="cpu")
        np.testing.assert_array_equal(kern.node_of, want.node_of)
