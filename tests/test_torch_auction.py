"""The port's auction steps and solve against the JAX package's, on the CPU.

The same numpy inputs go through each JAX function and its counterpart in
slurm_bridge_tpu_torch.solver.auction. Integer steps and the segmented scan
are compared bit for bit; ``price_step`` to rtol 1e-6 (its float32 log1p is
correctly rounded in the port and not in XLA); whole solves by ``node_of``
equality.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import slurm_bridge_tpu.solver.auction as ja
import slurm_bridge_tpu_torch.solver.auction as ta
from slurm_bridge_tpu.solver.snapshot import random_scenario
from slurm_bridge_tpu_torch.ops.bid_argmax import mix
from slurm_bridge_tpu_torch.parallel import backend
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


def test_mix_bit_exact():
    rng = np.random.default_rng(0)
    pi = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    ni = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    for salt in (0, 7, 2**31 + 5, 2**32 - 1):
        want = np.asarray(ja._mix(jnp.asarray(pi), jnp.asarray(ni), jnp.uint32(salt)))
        got = mix(T(pi.astype(np.int64)), T(ni.astype(np.int64)), salt)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize(
    "p_off,n_off,salt", [(0, 0, 3), (2**31 - 10, 17, 6), (-40, 2**31 - 3, 1)]
)
def test_hash_jitter_bit_exact(p_off, n_off, salt):
    want = np.asarray(ja.hash_jitter(37, 53, salt, jnp.float32, p_off=p_off, n_off=n_off))
    got = ta.hash_jitter(37, 53, salt, p_off=p_off, n_off=n_off, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [1, 2, 7, 64, 1001])
def test_segmented_cumsum_bit_exact(p):
    """Random magnitudes, so any change in the association of the adds
    shows up in the low bits."""
    rng = np.random.default_rng(p)
    vals = (rng.standard_normal((p, 3)) * 10.0 ** rng.integers(-2, 6, (p, 1))).astype(np.float32)
    seg = rng.random(p) < 0.1
    seg[0] = True
    want = np.asarray(jax.jit(ja.segmented_cumsum)(jnp.asarray(vals), jnp.asarray(seg)))
    got = ta.segmented_cumsum(T(vals), T(seg))
    np.testing.assert_array_equal(got.numpy(), want)


def test_segmented_cumsum_precision():
    """Large magnitudes must not leak across segments."""
    p = 50_000
    vals = torch.full((p, 1), 20_000.0)
    seg = torch.zeros(p, dtype=torch.bool)
    seg[0] = True
    seg[-2] = True  # last segment has exactly two rows
    out = ta.segmented_cumsum(vals, seg)
    assert out[-2, 0] == 20_000.0
    assert out[-1, 0] == 40_000.0


def test_segment_sum_in_row_order():
    """Bit-equal to XLA's CPU scatter-add (a sequential fold in row order)."""
    rng = np.random.default_rng(1)
    v = (rng.standard_normal((3000, 3)) * 10.0 ** rng.integers(-3, 6, (3000, 1))).astype(np.float32)
    seg = rng.integers(0, 9, 3000).astype(np.int32)
    want = np.asarray(jax.ops.segment_sum(jnp.asarray(v), jnp.asarray(seg), num_segments=11))
    got = ta.segment_sum(T(v), T(seg), 11)
    np.testing.assert_array_equal(got.numpy(), want)


def _round_state(seed, p=400, n=60):
    rng = np.random.default_rng(seed)
    gang = np.sort(rng.integers(0, p // 3, p)).astype(np.int32)
    gang = ja.normalize_gangs(gang)
    return dict(
        choice=rng.integers(0, n + 1, p).astype(np.int32),
        valid=rng.random(p) < 0.8,
        assign=np.where(rng.random(p) < 0.3, rng.integers(0, n, p), -1).astype(np.int32),
        gang=gang,
        dem=rng.integers(1, 20, (p, 3)).astype(np.float32) * 0.5,
        prio=np.round(rng.uniform(0, 100, p)).astype(np.float32),
        free=rng.integers(0, 60, (n, 3)).astype(np.float32),
        scale=np.float32([0.02, 0.001, 0.3]),
        n=n,
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_round_steps_bit_exact(seed):
    """multi_mask, gang_dedup, admission and gang_revoke on one round's
    state: identical outputs."""
    s = _round_state(seed)
    p, n = len(s["choice"]), s["n"]
    j = {k: jnp.asarray(v) for k, v in s.items() if k != "n"}
    t = {k: T(v) for k, v in s.items() if k != "n"}
    t["gang"] = t["gang"].long()

    j_multi = ja.multi_mask(j["gang"], p)
    t_multi = ta.multi_mask(t["gang"], p)
    np.testing.assert_array_equal(t_multi.numpy(), np.asarray(j_multi))

    jc, jv = jax.jit(ja.gang_dedup, static_argnums=5)(
        j["choice"], j["valid"], j["assign"], j["gang"], j_multi, n
    )
    tc, tv = ta.gang_dedup(t["choice"], t["valid"], t["assign"], t["gang"], t_multi, n)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))

    j_order = ja.prio_rank_order(j["prio"])
    t_order = ta.prio_rank_order(t["prio"])
    np.testing.assert_array_equal(t_order.numpy(), np.asarray(j_order))
    ja_adm = jax.jit(ja.admit_preordered, static_argnums=5)(
        jc, jv, j["dem"], j_order, j["free"], n
    )
    ta_adm = ta.admit_preordered(tc, tv, t["dem"], t_order, t["free"], n)
    np.testing.assert_array_equal(ta_adm.numpy(), np.asarray(ja_adm))

    np.testing.assert_array_equal(
        ta.gang_revoke(t["assign"], t["gang"], p).numpy(),
        np.asarray(ja.gang_revoke(j["assign"], j["gang"], p)),
    )
    np.testing.assert_array_equal(
        ta.used_capacity(t["dem"], t["assign"], n).numpy(),
        np.asarray(ja.used_capacity(j["dem"], j["assign"], n)),
    )


def test_price_step_close():
    """rtol 1e-6: the port's log1p is correctly rounded (taken in float64),
    XLA's float32 log1p is not, so prices may differ by an ulp."""
    s = _round_state(3)
    n = s["n"]
    price = np.random.default_rng(3).uniform(0, 2, n).astype(np.float32)
    dem_n = s["dem"] * s["scale"]
    want = np.asarray(ja.price_step(
        jnp.asarray(price), jnp.asarray(s["choice"]), jnp.asarray(s["valid"]),
        jnp.asarray(dem_n), jnp.asarray(s["free"]), jnp.asarray(s["scale"]), n, 0.5,
    ))
    got = ta.price_step(
        T(price), T(s["choice"]), T(s["valid"]), T(dem_n), T(s["free"]),
        T(s["scale"]), n, 0.5,
    )
    assert (want > price).any()  # some nodes were over-requested
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def _both(snap, batch, cfg_kw, incumbent=None):
    cfg = ja.AuctionConfig(**cfg_kw)
    a = ja.auction_place(snap, batch, cfg, incumbent=incumbent)
    b = ta.auction_place(
        snapshot_from(snap), batch_from(batch), config_from(cfg),
        incumbent=incumbent, device="cpu",
    )
    return a, b


_SCENARIOS = {
    "dense": ((200, 800), dict(seed=17, load=0.7, gpu_fraction=0.2, gang_fraction=0.1), dict(rounds=8)),
    "dense-nogang": ((256, 1200), dict(seed=11, load=0.8, gpu_fraction=0.15), dict(rounds=8)),
    "dense-gangfirst": ((120, 600), dict(seed=7, load=1.1, gang_fraction=0.3), dict(rounds=8, gang_first=True)),
    "sampled": ((200, 800), dict(seed=5, load=0.9, gpu_fraction=0.2, gang_fraction=0.1), dict(rounds=8, candidates=64)),
    "sampled-nogang": ((300, 1500), dict(seed=3, load=0.8), dict(rounds=8, candidates=64)),
}


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_auction_place_equals_jax(name):
    (n, j), kw, cfg = _SCENARIOS[name]
    snap, batch = random_scenario(n, j, **kw)
    a, b = _both(snap, batch, cfg)
    np.testing.assert_array_equal(b.node_of, a.node_of)
    np.testing.assert_allclose(b.free_after, a.free_after, atol=1e-3)
    _check_feasible(snap, batch, b)


@pytest.mark.parametrize("candidates", [0, 64])
def test_auction_place_with_incumbents_equals_jax(candidates):
    snap, batch = random_scenario(96, 500, seed=23, load=0.8, gang_fraction=0.1)
    base = ja.auction_place(snap, batch, ja.AuctionConfig(rounds=6))
    inc = np.where(base.placed & (np.arange(batch.num_shards) % 2 == 0), base.node_of, -1)
    inc = inc.astype(np.int32)
    a, b = _both(snap, batch, dict(rounds=6, candidates=candidates), incumbent=inc)
    np.testing.assert_array_equal(b.node_of, a.node_of)
    moved = (inc >= 0) & b.placed & (b.node_of != inc)
    assert not moved.any()


def test_kernel_path_equals_dense_path():
    """use_pallas=True (the wrapper's plain version on the CPU) and the
    dense branch place identically — the solve-level parity the card's
    kernel is held to in chip_smoke.py."""
    snap, batch = random_scenario(150, 700, seed=9, load=0.8, gpu_fraction=0.2, gang_fraction=0.1)
    s, b = snapshot_from(snap), batch_from(batch)
    a = ta.auction_place(s, b, ta.AuctionConfig(rounds=6, use_pallas=False), device="cpu")
    k = ta.auction_place(s, b, ta.AuctionConfig(rounds=6, use_pallas=True), device="cpu")
    np.testing.assert_array_equal(a.node_of, k.node_of)


@pytest.mark.parametrize("name", ["dense", "dense-gangfirst", "dense-nogang"])
def test_kernel_path_equals_jax(name):
    """The kernel path (on the CPU, the wrapper's plain version scoring
    only the unplaced rows) places as the JAX package's dense solve."""
    (n, j), kw, cfg = _SCENARIOS[name]
    snap, batch = random_scenario(n, j, **kw)
    a = ja.auction_place(snap, batch, ja.AuctionConfig(**cfg))
    b = ta.auction_place(
        snapshot_from(snap), batch_from(batch),
        ta.AuctionConfig(**cfg, use_pallas=True, candidates=0), device="cpu",
    )
    np.testing.assert_array_equal(b.node_of, a.node_of)


def test_auction_deterministic():
    snap, batch = random_scenario(64, 300, seed=3, gang_fraction=0.1)
    s, b = snapshot_from(snap), batch_from(batch)
    for cfg in (ta.AuctionConfig(), ta.AuctionConfig(candidates=8)):
        a1 = ta.auction_place(s, b, cfg, device="cpu")
        a2 = ta.auction_place(s, b, cfg, device="cpu")
        assert np.array_equal(a1.node_of, a2.node_of)


def test_kernel_bf16_falls_back_to_plain(caplog):
    """use_pallas + dtype="bfloat16" is unsupported (the kernel is
    float32-only): the solve warns and runs the dense branch."""
    snap, batch = random_scenario(16, 48, seed=1, load=0.5)
    s, b = snapshot_from(snap), batch_from(batch)
    with caplog.at_level(logging.WARNING, logger="sbt.auction"):
        a = ta.auction_place(
            s, b, ta.AuctionConfig(rounds=4, dtype="bfloat16", use_pallas=True), device="cpu"
        )
    assert any("unsupported" in r.message for r in caplog.records)
    c = ta.auction_place(
        s, b, ta.AuctionConfig(rounds=4, dtype="bfloat16", use_pallas=False), device="cpu"
    )
    assert np.array_equal(a.node_of, c.node_of)
    _check_feasible(snap, batch, a)


def test_resolve_candidates_and_kernel_auto():
    """"cuda" takes the place "tpu" has in the JAX package: the headline
    shape stays on the full argmax, through the kernel."""
    cfg = ta.AuctionConfig()
    assert ta.resolve_candidates(cfg, "cuda", 50_000, 10_000) == 0
    assert ta.resolve_candidates(cfg, "cpu", 50_000, 10_000) == 64
    assert ta.resolve_candidates(cfg, "cpu", 100, 64) == 0
    assert ta.resolve_candidates(ta.AuctionConfig(candidates=0), "cpu", 50_000, 10_000) == 0
    assert ta.resolve_candidates(ta.AuctionConfig(candidates=32), "cuda", 100, 64) == 32
    assert ta.resolve_kernel(cfg, "cuda", 0) is True
    assert ta.resolve_kernel(cfg, "cpu", 0) is False
    assert ta.resolve_kernel(cfg, "cuda", 64) is False
    assert [f for f in ta.AuctionConfig.__dataclass_fields__] == [
        f for f in ja.AuctionConfig.__dataclass_fields__
    ]
    assert ta.AuctionConfig() == config_from(ja.AuctionConfig())


def test_backend_never_hides_the_card(monkeypatch):
    """No CUDA: the default raises; the CPU runs only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SBT_BACKEND", raising=False)
    with pytest.raises(backend.BackendUnavailable):
        backend.ensure_backend()
    with pytest.raises(backend.BackendUnavailable):
        backend.ensure_backend("cuda")
    assert backend.ensure_backend("cpu") == "cpu"
    monkeypatch.setenv("SBT_BACKEND", "cpu")
    assert backend.ensure_backend() == "cpu"
    monkeypatch.setenv("SBT_BACKEND", "tpu")
    with pytest.raises(ValueError, match="SBT_BACKEND"):
        backend.ensure_backend()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.delenv("SBT_BACKEND")
    assert backend.ensure_backend() == "cuda"
    snap, batch = random_scenario(8, 10, seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(backend.BackendUnavailable):
        ta.auction_place(snapshot_from(snap), batch_from(batch))
