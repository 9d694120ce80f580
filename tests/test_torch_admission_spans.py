"""The policy's and the fast path's spans: the arrival-time admission as
one span per tick (``sim.arrive.admit``) with its attempts, binds and
misses by reason, the policy's class order (``policy.prepare``) and
backfill (``policy.backfill``), and the fast path's window install
(``admission.window``), each a part of the tick's phase dict beside
``PHASES`` and outside its sum; and the tick's published admit walls.

Driven on the CPU on ``interactive_storm`` at a small scale, the engine
pinned to the device auction (its plain branch on the CPU), as the
benchmark pins it.
"""

from __future__ import annotations

import dataclasses
import threading

import pytest
import torch

from chip_smoke import pin_auction
from slurm_bridge_tpu_torch.obs.tracing import TRACER
from slurm_bridge_tpu_torch.parallel import colpool
from slurm_bridge_tpu_torch.sim.harness import ADMIT_COUNTS, PHASES, SimHarness
from slurm_bridge_tpu_torch.sim.scenarios import SCENARIOS

SCALE = 0.25
#: each new span and the counters it carries
SPANS = {
    "sim.arrive.admit": ("attempts", "binds"),
    "policy.prepare": ("pending", "deferred"),
    "policy.backfill": ("candidates", "takes"),
    "admission.window": ("protected", "deductions"),
}
#: the new parts of the phase dict (durations, ms) and the phase each
#: lies inside
PARTS = {
    "arrive.admit": "arrive",
    "policy.prepare": "prepare",
    "policy.backfill": "other",
    "admission.window": "bind",
}
MISSES = [k for k in ADMIT_COUNTS if k.startswith("miss_")]


@pytest.fixture(autouse=True, scope="module")
def _few_threads_and_workers():
    """Two intra-op threads and two forked pool workers: the suite runs
    in parallel workers. No pool outlives the module."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    mp.setenv("SBT_COLPOOL_WORKERS", "2")
    yield
    mp.undo()
    colpool.reset()
    torch.set_num_threads(before)


def _storm(**over):
    return dataclasses.replace(pin_auction(SCENARIOS["interactive_storm"](scale=SCALE)), **over)


class _Spans:
    """Keeps the (name, counters) of every finished span of the tick's
    thread."""

    def __init__(self):
        self.seen: list[tuple[str, dict]] = []
        self.main = threading.main_thread().ident

    def export(self, span):
        if threading.get_ident() == self.main:
            self.seen.append((span.name, dict(span.counters)))


def _run(sc):
    """(harness, result, [phase dict per tick], the spans it finished)."""
    sink = _Spans()
    h = SimHarness(sc, device="cpu")
    TRACER.add_exporter(sink)
    try:
        result = h.run()
    finally:
        TRACER.remove_exporter(sink)
    return h, result, [dict(p) for p in h._tick_phases], sink.seen


@pytest.fixture(scope="module")
def storm():
    return _run(_storm())


def test_new_spans_carry_their_counters(storm):
    _h, _result, _ticks, seen = storm
    for name, counters in SPANS.items():
        found = [c for n, c in seen if n == name]
        assert found, name
        for key in counters:
            assert any(key in c for c in found), (name, key)
    admits = [c for n, c in seen if n == "sim.arrive.admit"]
    assert sum(c.get("binds", 0.0) for c in admits) > 0
    assert sum(c.get("miss_not_ready", 0.0) for c in admits) > 0
    prepares = [c for n, c in seen if n == "policy.prepare"]
    assert all(c["deferred"] <= c["pending"] for c in prepares)
    assert any(c["deferred"] > 0 for c in prepares)


def test_attempts_are_binds_plus_misses_on_every_tick(storm):
    h, result, ticks, _seen = storm
    for t, ph in enumerate(ticks):
        misses = sum(ph[f"arrive.admit.{k}"] for k in MISSES)
        assert ph["arrive.admit.attempts"] == ph["arrive.admit.binds"] + misses, t
    stats = result.determinism["admission"]
    assert sum(ph["arrive.admit.attempts"] for ph in ticks) == stats["attempts"]
    assert sum(ph["arrive.admit.binds"] for ph in ticks) == stats["binds"] > 0
    for k in MISSES:
        got = sum(ph[f"arrive.admit.{k}"] for ph in ticks)
        assert got == stats["misses"].get(k[len("miss_"):], 0), k


def test_published_walls_are_the_fast_binds_after_warmup(storm):
    h, result, ticks, _seen = storm
    warmup = h.scheduler.admission.config.latency_warmup_ticks
    walls = [w for ph in ticks for w in ph["arrive.admit.walls"]]
    assert len(walls) == result.quality["fastpath_binds"] > 0
    assert sorted(walls) == sorted(h.quality._fastpath_ms.values())
    for t, ph in enumerate(ticks):
        assert len(ph["arrive.admit.walls"]) <= ph["arrive.admit.binds"], t
        if t < warmup:
            assert ph["arrive.admit.walls"] == [], t
        assert all(w > 0.0 for w in ph["arrive.admit.walls"]), t


def test_new_parts_stay_outside_the_phase_sum(storm):
    _h, _result, ticks, _seen = storm
    for t, ph in enumerate(ticks):
        assert ph["tick"] == sum(ph[k] for k in PHASES), t
        for part, phase in PARTS.items():
            assert 0.0 <= ph[part] <= ph[phase] + 1e-9, (t, part)
    for part in PARTS:
        assert sum(ph[part] for ph in ticks) > 0.0, part


def test_digests_and_decisions_equal_with_the_recorder_off(storm):
    h_on, on, ticks_on, _seen = storm
    h_off, off, ticks_off, _ = _run(_storm(tracing=False))
    assert h_off.flight.records == [] and h_on.flight.records
    for key in ("digest", "final_state_digest", "final_outcome_digest", "admission"):
        assert on.determinism[key] == off.determinism[key], key
    assert sorted(h_on.quality._fastpath_ms) == sorted(h_off.quality._fastpath_ms)
    binds = [ph["arrive.admit.binds"] for ph in ticks_on]
    assert binds == [ph["arrive.admit.binds"] for ph in ticks_off]


def test_parts_read_zero_without_policy_or_admission():
    sc = _storm(policy=None, admission=None, ticks=4)
    h = SimHarness(sc, device="cpu")
    try:
        ticks = [dict(h.run_tick(t)) for t in range(sc.ticks)]
    finally:
        h._cleanup()
    for ph in ticks:
        for part in PARTS:
            assert ph[part] == 0.0, part
        for key in ADMIT_COUNTS:
            assert ph[f"arrive.admit.{key}"] == 0.0, key
        assert ph["arrive.admit.walls"] == []
