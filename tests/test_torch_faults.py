"""The fault gates: the port's chaos, fault and shard scenarios against the
JAX package's, with the engine pinned as chip_smoke.py phase [16] pins it
on the card.

(a) Every scenario of :data:`chip_smoke.FAULT_CELLS` (and the crash-free
    twin of each with a ``lossless_twin``) at scale 0.05, each shard on the
    single-device engine: the port's :func:`chip_smoke.fault_record` —
    digests, bound, recovery ticks, restarts, agent restarts, virtual-node
    deletions, RPC retries, wait reasons, the shard block — and each
    tick's solves equal the JAX package's run of the same arm
    (``tools/port_reference.py --sim NAME --scale S --arm ARM``).
(b) ``sim/cli.py``'s ``_smoke`` gates (:func:`chip_smoke.fault_gates`) hold
    on the port's pinned runs at ``SMOKE_SCALE``: the five crash scenarios
    with their crash-free twins, and the two sharded scenarios.
(c) The kernel's block ranges on real fault operands: the auction's round
    operands of pinned port runs of ``partition_vanish`` (inside and after
    its window) and ``node_churn``, sent through the kernel's wrapper (its
    plain version here); on each call :func:`node_order`, the work list and
    :func:`tile_ranges` are built as the card builds them, and every live
    row's plain choice and every node feasible for it lie inside its
    tile's ``[lo, hi)`` — wildcard rows, padding rows and a partition with
    no nodes among them.

No tolerance: every compared value is exact.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import pathlib

import pytest
import torch

import slurm_bridge_tpu.parallel.colpool as jax_colpool
import slurm_bridge_tpu.sim.faults as jax_faults
import slurm_bridge_tpu_torch.ops.bid_argmax as kern
import slurm_bridge_tpu_torch.parallel.colpool as port_colpool
import slurm_bridge_tpu_torch.policy.engine as port_engine
import slurm_bridge_tpu_torch.sim.cli as port_cli
import slurm_bridge_tpu_torch.sim.faults as port_faults
import slurm_bridge_tpu_torch.sim.harness as port_harness
import slurm_bridge_tpu_torch.sim.scenarios as port_scenarios
import slurm_bridge_tpu_torch.solver.auction as port_auction
import slurm_bridge_tpu_torch.solver.session as port_session
from chip_smoke import FAULT_CELLS, arm_scenario, fault_gates, fault_record, pin_auction
from slurm_bridge_tpu_torch.solver.snapshot import PAD_PARTITION

REPO = pathlib.Path(__file__).resolve().parents[1]
PARITY_SCALE = 0.05
CRASH_KINDS = port_faults.BRIDGE_KINDS + port_faults.AGENT_KINDS


def _load_port_reference():
    spec = importlib.util.spec_from_file_location("port_reference",
                                                  REPO / "tools" / "port_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


port_reference = _load_port_reference()
#: (scenario, arm): every run of phase [16]
RUN_CASES = [(name, arm) for name in FAULT_CELLS
             for arm in (("on", "crash_free") if port_scenarios.SCENARIOS[name]().lossless_twin
                         else ("on",))]
#: the scenarios whose ``_smoke`` gates (b) runs: a crash-free twin or a shard plan
GATE_CASES = [name for name in FAULT_CELLS
              if port_scenarios.SCENARIOS[name]().lossless_twin
              or port_scenarios.SCENARIOS[name]().sharding is not None]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _reap_pools(monkeypatch):
    """Two forked pool workers per run, and neither package's pool
    outlives a test."""
    monkeypatch.setenv("SBT_COLPOOL_WORKERS", "2")
    yield
    port_colpool.reset()
    jax_colpool.reset()


def _scenario(name: str, scale: float, arm: str = "on"):
    """The port's scenario under ``arm``, pinned as chip_smoke.py pins it."""
    sc = arm_scenario(port_scenarios.SCENARIOS[name](scale=scale), arm,
                      port_engine.PolicyConfig, crash_kinds=CRASH_KINDS)
    return pin_auction(sc)


def _port(name: str, scale: float, arm: str = "on"):
    """The port's run: (its scenario, :func:`fault_record` with each
    tick's solves)."""
    sc = _scenario(name, scale, arm)
    h = port_harness.SimHarness(sc, device="cpu")
    result = h.run()
    return sc, dict(fault_record(result), solves=[m["solves"] for m in h._tick_meta])


@pytest.mark.parametrize("name,arm", RUN_CASES, ids=[f"{n}-{a}" for n, a in RUN_CASES])
def test_fault_run_equals_the_jax_package(name, arm):
    ref = port_reference.run_sim(name, PARITY_SCALE, arm)
    sc, got = _port(name, PARITY_SCALE, arm)
    assert sc.auction_config.rounds == 8 and sc.auction_config.candidates == 0
    assert sc.sharding is None or sc.sharding.device_solve is False
    # violations included: at 0.05 ``preemption_storm``'s 8 nodes leave one
    # pod pending past its drain grace in both packages alike
    assert got == dict(ref["fault"], solves=ref["solves"])


@pytest.mark.parametrize("name", GATE_CASES)
def test_smoke_gates_hold_on_the_ports_pinned_runs(name):
    scale = port_cli.SMOKE_SCALE
    sc, rec = _port(name, scale)
    twin = _port(name, scale, "crash_free")[1] if sc.lossless_twin else None
    gates = fault_gates(name, sc, rec, twin, port_faults.BRIDGE_KINDS, port_faults.AGENT_KINDS)
    assert [g for g in gates if not g[1]] == []
    names = [g[0] for g in gates]
    if sc.lossless_twin:
        assert any(n.startswith("crash-free twin") for n in names)
    if sc.sharding is not None:
        assert "plan shards" in names
    if name == "sharded_gang_split":
        assert "cross-shard reconcile placed" in names


def test_the_crash_free_arm_is_the_smoke_gates_twin():
    """The twin keeps every fault but the bridge and agent crashes, as
    ``_smoke`` strips them (both packages' kinds are the same)."""
    assert CRASH_KINDS == jax_faults.BRIDGE_KINDS + jax_faults.AGENT_KINDS
    base = port_scenarios.SCENARIOS["chaos_crash_into_vanished_partition"](scale=0.05)
    twin = arm_scenario(base, "crash_free", port_engine.PolicyConfig, crash_kinds=CRASH_KINDS)
    assert twin.faults == base.faults.strip(CRASH_KINDS)
    assert {f.kind for f in base.faults.faults} == {"partition_vanish", "crash_restart"}
    assert {f.kind for f in twin.faults.faults} == {"partition_vanish"}
    assert dataclasses.replace(twin, faults=base.faults) == base


@functools.lru_cache(maxsize=None)
def _round_calls(name: str, scale: float) -> tuple:
    """Every call of the kernel's wrapper in a pinned port run of ``name``
    with the kernel's route forced (its plain version on these CPU
    tensors): (tick, operands, salt, live, keywords, plain result)."""
    calls, tick = [], [None]
    real_call, real_resolve = port_auction.bid_argmax, port_auction.resolve_kernel
    real_session_resolve = port_session.resolve_kernel

    def record(*args, **kw):
        out = real_call(*args, **kw)
        calls.append((tick[0], tuple(a.clone() for a in args[:10]), args[10],
                      kw["live"].clone(), {k: kw[k] for k in ("jitter", "affinity_weight",
                                                               "num_nodes")},
                      tuple(t.clone() for t in out)))
        return out

    h = port_harness.SimHarness(_scenario(name, scale), device="cpu")
    real_tick = h.run_tick

    def run_tick(t, **kw):
        tick[0] = t
        return real_tick(t, **kw)

    h.run_tick = run_tick
    port_auction.bid_argmax = record
    port_auction.resolve_kernel = port_session.resolve_kernel = lambda cfg, backend, k: k == 0
    try:
        h.run()
    finally:
        port_auction.bid_argmax = real_call
        port_auction.resolve_kernel = real_resolve
        port_session.resolve_kernel = real_session_resolve
    return tuple(calls)


def _check_block_ranges(args, live, kw, out) -> dict:
    """The kernel's node order, work list and tile ranges on one call's
    operands; every live row's choice (``out``: the wrapper's plain
    result) and feasible nodes inside its tile's range. Returns the counts
    of live wildcard, padding and node-less partition rows."""
    free, node_part, node_feat, price, dem, job_part, req_feat, incumbent = args[:8]
    n, p = kw["num_nodes"], dem.shape[0]
    order, offsets = kern.node_order(node_part, "cpu")
    rows, count = kern.work_list_plain(live, kern.row_order(job_part))
    lo, hi = kern.tile_ranges(rows, count, job_part, offsets, n)
    c = int(count)
    assert c == int(live.sum())
    pos = torch.empty(n, dtype=torch.long)
    pos[order.long()] = torch.arange(n)
    slot = torch.full((p,), -1, dtype=torch.long)
    slot[rows[:c].long()] = torch.arange(c)
    live_rows = torch.nonzero(live).squeeze(1)
    tile = slot[live_rows] // kern.TILE_ROWS
    lo_r, hi_r = lo[tile].long()[:, None], hi[tile].long()[:, None]
    # the plain version's feasibility (ops/bid_argmax.py: bid_argmax_plain)
    jp = job_part[live_rows, None]
    ok = (jp == node_part[None, :]) | (jp < 0)
    rf = req_feat[live_rows, None].to(torch.int64) & 0xFFFFFFFF
    ok &= (node_feat[None, :].to(torch.int64) & 0xFFFFFFFF & rf) == rf
    ok &= (dem[live_rows, None, :] <= free[None, :, :] + 1e-6).all(-1)
    inc = incumbent[live_rows, None]
    ok &= (inc < 0) | (torch.arange(n)[None, :] == inc)
    inside = (pos[None, :] >= lo_r) & (pos[None, :] < hi_r)
    assert not (ok & ~inside).any(), "a feasible node lies outside its row's tile range"
    chosen = out[1][live_rows].long()
    placed = chosen < n
    assert torch.equal(placed, ok.any(1))
    cpos = pos[chosen[placed]]
    assert ((cpos >= lo_r[placed, 0]) & (cpos < hi_r[placed, 0])).all()
    k = offsets.shape[0] - 1
    part = job_part[live_rows].long()
    sizes = offsets[1:] - offsets[:-1]
    nodeless = (part >= 0) & (part < k) & (sizes[part.clamp(0, max(k - 1, 0))] == 0)
    return dict(wildcard=int((part < 0).sum()), padding=int((part == int(PAD_PARTITION)).sum()),
                nodeless=int(nodeless.sum()) if k else 0)


@pytest.mark.parametrize("name", ["partition_vanish", "node_churn"])
def test_block_ranges_hold_on_fault_operands(name):
    sc = _scenario(name, port_cli.SMOKE_SCALE)
    start = min(f.start_tick for f in sc.faults.faults)
    end = max(f.end_tick for f in sc.faults.faults)
    calls = _round_calls(name, port_cli.SMOKE_SCALE)
    ticks = {c[0] for c in calls}
    assert any(start <= t < end for t in ticks) and any(t >= end for t in ticks)
    seen = dict(wildcard=0, padding=0, nodeless=0)
    for _, args, _, live, kw, out in calls:
        for key, v in _check_block_ranges(args, live, kw, out).items():
            seen[key] += v
    assert seen["padding"] > 0
    if name == "partition_vanish":
        # a pending job of the vanished partition encodes as the wildcard
        assert seen["wildcard"] > 0


def test_block_ranges_hold_with_a_partition_without_nodes():
    """``node_churn``'s operands inside its window with every node of
    partition 1 moved to partition 2: rows of partition 1 keep their code,
    which now has no nodes (an empty range between two others)."""
    calls = [c for c in _round_calls("node_churn", port_cli.SMOKE_SCALE) if c[0] == 4]
    assert calls
    seen = 0
    for _, args, salt, live, kw, _ in calls:
        node_part = args[1].clone()
        assert (node_part == 1).any() and (node_part == 2).any()
        node_part[node_part == 1] = 2
        moved = (args[0], node_part, *args[2:])
        out = kern.bid_argmax(*moved, salt, **kw, live=live)
        counts = _check_block_ranges(moved, live, kw, out)
        seen += counts["nodeless"]
    assert seen > 0


def test_the_cards_gang_split_scale_cuts_shards_below_a_gang():
    """Phase [16]'s ``sharded_gang_split`` must split its gangs across
    shards, or its reconcile gate has nothing to count: at scale 2 its
    shards (12 nodes) hold an 8-node gang, at phase [16]'s scale they do
    not."""
    def shard_and_gang(scale):
        sc = port_scenarios.sharded_gang_split(scale=scale)
        return sc.sharding.max_nodes_per_shard, sc.workload.gang_size

    shard, gang = shard_and_gang(FAULT_CELLS["sharded_gang_split"]["scale"])
    assert shard < gang
    assert shard_and_gang(2.0)[0] >= gang
