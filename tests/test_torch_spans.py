"""The port's spans as the tick's one clock: the simulator's phases and
their parts read from the spans' own durations, the spans of the tick's
thread on ``torch.profiler``'s trace as ranges of the same names, the
solve's host syncs counted, and no span per reconciled job.

Driven on the CPU at a tiny size with the engine pinned to the device
auction (its plain branch on the CPU), as the benchmark pins it.
"""

from __future__ import annotations

import threading
from collections import Counter

import pytest
import torch

from slurm_bridge_tpu_torch.obs.tracing import TRACER, InMemoryExporter, Tracer
from slurm_bridge_tpu_torch.sim.harness import PHASES, Scenario, SimHarness
from slurm_bridge_tpu_torch.sim.trace import ClusterSpec, WorkloadSpec
from slurm_bridge_tpu_torch.solver.auction import AuctionConfig

#: the spans that name the tick's time inside its phases
PART_SPANS = (
    "scheduler.store.pending", "scheduler.store.inventory", "scheduler.prepare",
    "solve.rounds", "solve.repair", "sim.mirror.fetch_wait",
)
#: what a tick's phase dict carries beside PHASES
PARTS = (
    "store.pending", "store.inventory", "prepare", "solve.repair", "solve.host_syncs",
    "mirror.submit", "mirror.status", "mirror.sweep",
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _scenario(seed: int = 7) -> Scenario:
    return Scenario(
        name="spans-tiny",
        cluster=ClusterSpec(num_nodes=48, num_partitions=2),
        workload=WorkloadSpec(jobs=240, arrival="poisson", spread_ticks=3,
                              duration_range=(5.0, 15.0)),
        ticks=5,
        seed=seed,
        backend="auction",
        auction_config=AuctionConfig(rounds=8, candidates=0),
        drain_grace_ticks=40,
    )


def _ticks(n: int = 5, seed: int = 7):
    """(harness, [phase dict per tick]) of ``n`` ticks."""
    h = SimHarness(_scenario(seed), device="cpu")
    try:
        return h, [dict(h.run_tick(t)) for t in range(n)]
    finally:
        h._cleanup()


def test_parts_lie_inside_their_phases():
    h, ticks = _ticks()
    assert any(t["solve"] > 0 for t in ticks)
    for t, ph in enumerate(ticks):
        assert set(PARTS) <= set(ph), t
        assert ph["tick"] == sum(ph[k] for k in PHASES)
        assert ph["store.pending"] + ph["store.inventory"] <= ph["store"] + 1e-9, t
        assert (ph["mirror.submit"] + ph["mirror.status"] + ph["mirror.sweep"]
                <= ph["mirror"] + 1e-9), t
        assert ph["prepare"] <= ph["other"] + 1e-9, t
        assert ph["solve.repair"] <= ph["solve"] + 1e-9, t
    assert sum(t["store.inventory"] for t in ticks) > 0
    assert sum(t["mirror.status"] for t in ticks) > 0


def test_phases_are_the_flight_records_own():
    """The harness's phases and the flight record's are one measurement:
    equal tick by tick, up to the record's rounding to a microsecond."""
    h, ticks = _ticks()
    assert len(h.flight.records) == len(ticks)
    for rec, ph in zip(h.flight.records, ticks):
        lifted = h.flight.phases_ms(rec)
        for k in PHASES:
            assert lifted[k] == pytest.approx(ph[k], abs=2e-3), k


def test_parts_exist_with_the_recorder_off():
    import dataclasses

    h = SimHarness(dataclasses.replace(_scenario(), tracing=False), device="cpu")
    try:
        ticks = [dict(h.run_tick(t)) for t in range(3)]
    finally:
        h._cleanup()
    assert h.flight.records == []
    assert sum(t["store.inventory"] for t in ticks) > 0
    assert all(t["tick"] == sum(t[k] for k in PHASES) for t in ticks)


def test_host_syncs_repeat_exactly_for_one_seed():
    _h, a = _ticks(seed=11)
    _h, b = _ticks(seed=11)
    syncs = [t["solve.host_syncs"] for t in a]
    assert syncs == [t["solve.host_syncs"] for t in b]
    assert sum(syncs) > 0
    assert all(s == int(s) for s in syncs)


def test_tick_spans_are_profiler_ranges_and_no_others(monkeypatch):
    """Under ``torch.profiler`` every span the tick's thread opens and
    closes is a range of its name, and no span of another thread (the
    mirror's overlapped fetch) is. Spans stitched in after the fact
    (``emit_synthetic``: a forked worker's measured phases) were never
    open, so they are no range either."""
    finished: list[tuple[str, int]] = []
    stitched: set[str] = set()

    class ByThread:
        def export(self, span):
            finished.append((span.name, threading.get_ident()))

    emit = TRACER.emit_synthetic

    def stitch(name, **kw):
        stitched.add(name)
        return emit(name, **kw)

    monkeypatch.setattr(TRACER, "emit_synthetic", stitch)
    sink = ByThread()
    h = SimHarness(_scenario(), device="cpu")
    TRACER.add_exporter(sink)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for t in range(4):
                h.run_tick(t)
    finally:
        TRACER.remove_exporter(sink)
        h._cleanup()
    main = threading.main_thread().ident
    on_main = Counter(n for n, tid in finished if tid == main and n not in stitched)
    elsewhere = Counter(n for n, tid in finished if tid != main)
    assert elsewhere, "no span closed off the tick's thread"
    ranges = Counter(e.name for e in prof.events() if e.name in on_main or e.name in elsewhere)
    assert ranges == on_main
    for name in PART_SPANS:
        assert on_main[name] > 0, name
    for name in ("sim.tick", "sim.verify", "sim.mirror", "operator.sweep"):
        assert ranges[name] > 0, name


def test_no_range_without_a_profiler_or_off_the_main_thread():
    ctx = TRACER.span("plain")
    with ctx:
        assert ctx._range is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        on = TRACER.span("on-main")
        with on:
            assert on._range is not None
        seen = []

        def worker():
            c = TRACER.span("off-main")
            with c:
                seen.append(c._range)

        th = threading.Thread(target=worker)
        th.start()
        th.join()
    assert seen == [None]
    assert on._range is not None


def test_tally_counts_the_calling_threads_spans():
    """Inside the block only; another thread's spans and spans closed
    after the block add nothing."""
    tracer = Tracer(sample="never")

    def worker():
        with tracer.span("c"):
            pass

    with tracer.tally() as tally:
        with tracer.span("a"):
            with tracer.span("b"):
                pass
        with tracer.span("b"):
            pass
        th = threading.Thread(target=worker)
        th.start()
        th.join()
    with tracer.span("after"):
        pass
    assert set(tally) == {"a", "b"}
    assert tally["a"] >= 0.0 and tally["b"] >= 0.0
    assert tracer._tally is None
    with tracer.tally() as fresh:
        pass
    assert fresh == {} and fresh is not tally


def test_no_span_per_reconciled_job():
    """The tick records no ``operator.reconcile`` span, only the sweep."""
    h, _ticks_ = _ticks(n=4)
    for rec in h.flight.records:
        assert "operator.reconcile" not in rec["self_ms_by_name"]
        assert "operator.sweep" in rec["self_ms_by_name"]


def test_sweep_settles_its_slow_keys_inside_its_span(monkeypatch):
    from slurm_bridge_tpu_torch.bridge.operator import BridgeOperator

    h = SimHarness(_scenario(), device="cpu")
    try:
        op = h.operator
        assert isinstance(op, BridgeOperator)
        settled: list[str] = []
        monkeypatch.setattr(op, "_sweep_cols", lambda span, names, jt, pt: ["k2", "k1"])
        monkeypatch.setattr(op, "_sweep", lambda span, names: ["k2", "k1"])
        monkeypatch.setattr(op, "reconcile", settled.append)
        assert op.sweep(["x"]) == ["k2", "k1"] and settled == []
        mem = InMemoryExporter()
        with TRACER.recording(mem):
            assert op.sweep(["x"], settle=True) == []
        assert settled == ["k2", "k1"]
        [span] = [s for s in mem.spans if s.name == "operator.sweep"]
        assert span.counters["reconciles"] == 2
        assert span.counters["reconcile_ms"] >= 0.0
    finally:
        h._cleanup()


def test_result_wait_counts_one_host_sync():
    """On the card a solve's result waits on its copy's event: one host
    sync, counted where it waits (a stand-in event on the CPU)."""
    from slurm_bridge_tpu_torch.solver import auction, random_scenario
    from slurm_bridge_tpu_torch.solver.session import PendingSolve

    class Event:
        waits = 0

        def synchronize(self):
            Event.waits += 1

    snap, batch = random_scenario(40, 120, seed=3)
    pending = PendingSolve(
        _assign=torch.full((batch.num_shards,), -1, dtype=torch.int32),
        _event=Event(),
        _snapshot=snap,
        _batch=batch,
    )
    before = auction.HOST_SYNCS
    placement = pending.result()
    assert auction.HOST_SYNCS - before == 1 and Event.waits == 1
    assert not placement.placed.any()
