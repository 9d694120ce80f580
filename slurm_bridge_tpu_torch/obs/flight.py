"""Tick flight recorder — one span tree + attribution record per tick.

The ROADMAP's open question after PR-4 ("the residual 5.2 s is spread
across proto decode, commit machinery and object builds") was a guess
from ad-hoc timers. This module turns every full-bridge tick into
measured data: the sim harness (and any embedder) opens a recording
window per tick, every product-layer span lands in it (scheduler phases,
operator sweep, provider sync, RPC spans — wired through the ambient
contextvar and the gRPC traceparent metadata), and the window closes into
a compact machine-readable record:

- the **phase tree**: spans grouped by name under their parent, with
  durations and the numeric counters they carried (rows decoded, commits
  written, pods scanned);
- **top spans by self-time** (duration minus child durations) — where the
  tick actually went, not just which phase wrapped it;
- the **commit breakdown**: per-kind × per-callsite store commit deltas
  for the tick (the store's always-on attribution ledger), which sum to
  the tick's total commits by construction;
- **counter deltas**: every REGISTRY counter that moved during the tick.

Recording swaps the tracer's sampler to always-on for the window and
restores it after, so the flight recorder works regardless of the
process-wide sampling policy, and tests/embedders leave no global state
behind.

Spans mark phases and batches, never single objects: the operator's sweep
counts the reconciles it drives (``reconciles``, ``reconcile_ms``) rather
than opening a span per job, so a churn tick records about a hundred
spans, not one per finished or unsettled job.
"""

from __future__ import annotations

import contextlib
import threading
from collections import deque

import numpy as np

from slurm_bridge_tpu_torch.obs.metrics import REGISTRY
from slurm_bridge_tpu_torch.obs.tracing import TRACER, Span, Tracer

#: span names whose subtrees are the canonical tick phases — used to lift
#: a ``phases_ms`` view out of the span tree (must stay in lockstep with
#: the wiring in bridge/scheduler.py and sim/harness.py)
PHASE_SPANS = {
    "arrive": ("sim.arrive",),
    "store": ("scheduler.store",),
    "encode": ("scheduler.encode",),
    "solve": ("scheduler.solve",),
    "bind": ("scheduler.bind",),
    "mirror": ("sim.mirror",),
    #: the harness's own bookkeeping — ground-truth step, invariant
    #: checks, quality sampling, digest notes. Named (ISSUE 14) so the
    #: phase-sum reconciliation holds at the 500k shape, where this used
    #: to be seconds of unattributed root-span self time.
    "verify": ("sim.verify",),
}


def _tree(spans: list[Span], root: Span, max_depth: int = 6) -> dict:
    """Group the captured spans into a name-keyed tree under ``root``.

    Children with the same name merge into one node carrying ``count``,
    summed ``ms`` and summed counters — an RPC fan-out of 23 JobsInfo
    chunks renders as one node, not 23.
    """
    by_parent: dict[str, list[Span]] = {}
    for s in spans:
        if s.parent_id:
            by_parent.setdefault(s.parent_id, []).append(s)

    def build(group: list[Span], depth: int) -> dict:
        node: dict = {
            "ms": round(sum(s.duration for s in group) * 1e3, 3),
            "count": len(group),
        }
        counters: dict[str, float] = {}
        for s in group:
            for k, v in s.counters.items():
                counters[k] = counters.get(k, 0.0) + v
        if counters:
            node["counters"] = {k: counters[k] for k in sorted(counters)}
        if depth < max_depth:
            children: dict[str, list[Span]] = {}
            for s in group:
                for c in by_parent.get(s.span_id, ()):
                    children.setdefault(c.name, []).append(c)
            if children:
                node["children"] = {
                    name: build(kids, depth + 1)
                    for name, kids in sorted(children.items())
                }
        return node

    return {root.name: build([root], 0)}


def _self_times(spans: list[Span], root: Span) -> dict[str, tuple[int, float, float]]:
    """name -> (count, total_ms, self_ms) over the captured window."""
    child_sum: dict[str, float] = {}
    for s in spans:
        if s.parent_id:
            child_sum[s.parent_id] = child_sum.get(s.parent_id, 0.0) + s.duration
    agg: dict[str, tuple[int, float, float]] = {}
    for s in [*spans, root]:
        self_s = max(0.0, s.duration - child_sum.get(s.span_id, 0.0))
        n, tot, slf = agg.get(s.name, (0, 0.0, 0.0))
        agg[s.name] = (n + 1, tot + s.duration * 1e3, slf + self_s * 1e3)
    return agg


class FlightRecorder:
    """Per-tick span capture + attribution records.

    Usage (the sim harness's shape)::

        rec = FlightRecorder(store=harness.store)
        with rec.tick(5) as root:          # root span "sim.tick"
            ... run the tick ...
        rec.records[-1]                    # the flight record just built

    Disabled (``enabled=False``) it is a true no-op: no sampler swap, no
    root span, no capture — the tracing-off half of the overhead gate.
    """

    def __init__(
        self,
        *,
        tracer: Tracer | None = None,
        store=None,
        enabled: bool = True,
        root_name: str = "sim.tick",
        capacity: int = 30_000,
        top_n: int = 10,
    ):
        self.tracer = tracer or TRACER
        self.store = store
        self.enabled = enabled
        self.root_name = root_name
        self.capacity = capacity
        self.top_n = top_n
        self.records: list[dict] = []
        #: raw-span ring (debugging / tracez): keep-NEWEST, evictions
        #: counted in ``spans_dropped``. Since ISSUE 14 the RECORD no
        #: longer depends on it — every finishing span folds into the
        #: per-path/per-name rollups below at export time, so a storm
        #: tick of RPC chunks overflowing the ring still produces exact
        #: path totals and the phase-sum reconciliation holds at any scale.
        self._spans: deque[Span] = deque(maxlen=capacity)
        self._dropped = 0
        self._truncated = 0
        self._seen = 0
        self._lock = threading.Lock()
        #: name-path tuple → [count, total_ms, counters|None]
        self._paths: dict[tuple, list] = {}
        #: name → [count, total_ms, self_ms]
        self._names: dict[str, list] = {}
        #: open-span id → summed child duration (popped at finish)
        self._child_sum: dict[str, float] = {}

    # -- exporter interface (the capture sink) -----------------------------
    def export(self, span: Span) -> None:
        dur = span.duration
        # resolve the full name path NOW: ancestors are still open (a
        # span always finishes before its parent), and the Span.parent
        # chain reaches them without any lookup table
        parts = [span.name]
        p = span.parent
        depth = 0
        while p is not None and depth < 64:
            parts.append(p.name)
            p = p.parent
            depth += 1
        truncated = p is not None  # >64 ancestors: pathological nesting
        parts.reverse()
        path = tuple(parts)
        ms = dur * 1e3
        with self._lock:
            self._seen += 1
            if truncated:
                # a truncated path cannot anchor under the root and
                # would silently vanish from the tree — count it so the
                # reconciliation gate's failure is explicable
                self._truncated += 1
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(span)
            child = self._child_sum.pop(span.span_id, 0.0)
            if span.parent_id:
                self._child_sum[span.parent_id] = (
                    self._child_sum.get(span.parent_id, 0.0) + dur
                )
            self_ms = max(0.0, dur - child) * 1e3
            ent = self._names.get(span.name)
            if ent is None:
                self._names[span.name] = [1, ms, self_ms]
            else:
                ent[0] += 1
                ent[1] += ms
                ent[2] += self_ms
            pent = self._paths.get(path)
            if pent is None:
                pent = self._paths[path] = [0, 0.0, None]
            pent[0] += 1
            pent[1] += ms
            if span.counters:
                if pent[2] is None:
                    pent[2] = dict(span.counters)
                else:
                    acc = pent[2]
                    for k, v in span.counters.items():
                        acc[k] = acc.get(k, 0.0) + v

    # -- the capture window ------------------------------------------------
    @contextlib.contextmanager
    def tick(self, tick_no: int, **tags):
        if not self.enabled:
            yield None
            return
        self._spans.clear()
        self._dropped = 0
        self._truncated = 0
        self._seen = 0
        self._paths = {}
        self._names = {}
        self._child_sum = {}
        commits0 = (
            self.store.commit_counts_snapshot() if self.store is not None else {}
        )
        counters0 = REGISTRY.counter_totals()
        root = None
        try:
            with self.tracer.recording(self):
                with self.tracer.span(self.root_name, tick=tick_no, **tags) as r:
                    root = r
                    yield r
        finally:
            if root is not None:
                self.records.append(
                    self._build(tick_no, root, commits0, counters0)
                )

    def _tree_from_paths(self, root: Span) -> dict:
        """The name-keyed span tree rebuilt from the per-path rollup —
        same shape ``_tree`` produced from raw spans, but exact under
        ring eviction (dropped spans already contributed at export)."""
        root_node: dict = {"ms": 0.0, "count": 0}
        for path in sorted(self._paths):
            if not path or path[0] != root.name:
                continue  # ambient spans outside the tick trace
            count, ms, counters = self._paths[path]
            node = root_node
            for name in path[1:]:
                node = node.setdefault("children", {}).setdefault(
                    name, {"ms": 0.0, "count": 0}
                )
            node["ms"] = round(node["ms"] + ms, 3)
            node["count"] += count
            if counters:
                node["counters"] = {
                    k: counters[k] for k in sorted(counters)
                }
        return {root.name: root_node}

    def _build(self, tick_no, root, commits0, counters0) -> dict:
        commits: dict[str, int] = {}
        if self.store is not None:
            for key, n in self.store.commit_counts_snapshot().items():
                d = n - commits0.get(key, 0)
                if d:
                    commits[f"{key[0]}.{key[1]}"] = d
        counters = {
            name: round(total - counters0.get(name, 0.0), 3)
            for name, total in REGISTRY.counter_totals().items()
            if total != counters0.get(name, 0.0)
        }
        agg = self._names
        top = sorted(agg.items(), key=lambda kv: -kv[1][2])[: self.top_n]
        return {
            "tick": tick_no,
            "total_ms": round(root.duration * 1e3, 3),
            "spans": self._seen,
            "spans_dropped": self._dropped,
            "paths_truncated": self._truncated,
            "tree": self._tree_from_paths(root),
            "top_self_ms": [
                {
                    "name": name,
                    "count": n,
                    "total_ms": round(tot, 3),
                    "self_ms": round(slf, 3),
                }
                for name, (n, tot, slf) in top
            ],
            # UNtruncated by-name totals (span names are few dozen at
            # most) — the run aggregate sums these, so a cost that is
            # 11th-by-self-time every tick still shows up in the run view
            "self_ms_by_name": {
                name: {
                    "count": n,
                    "total_ms": round(tot, 3),
                    "self_ms": round(slf, 3),
                }
                for name, (n, tot, slf) in sorted(agg.items())
            },
            "commits": dict(sorted(commits.items())),
            "commits_total": sum(commits.values()),
            "counters": dict(sorted(counters.items())),
        }

    # -- aggregation -------------------------------------------------------
    def phases_ms(self, record: dict) -> dict[str, float]:
        """Lift the canonical phase durations out of one record's tree,
        including the ``other`` bucket (scheduler tick time outside the
        four named phases) — the same decomposition the harness timing
        reports, derived purely from spans."""

        def find(node: dict, name: str) -> float:
            for child_name, child in node.get("children", {}).items():
                if child_name == name:
                    return child["ms"]
                found = find(child, name)
                if found:
                    return found
            return 0.0

        root = next(iter(record["tree"].values()))
        out = {}
        for phase, names in PHASE_SPANS.items():
            out[phase] = sum(find(root, n) for n in names)
        sched = find(root, "scheduler.tick")
        out["other"] = max(
            0.0,
            sched - sum(out[p] for p in ("store", "encode", "solve", "bind")),
        )
        return out

    def aggregate(self) -> dict:
        """The run-level flight record for the headline JSON: p50 span
        tree by path, aggregate top self-time, summed commit breakdown."""
        if not self.records:
            return {}
        # Per-path p50 over ticks. A path ABSENT from a record counts as
        # 0.0 ms in that record — the span genuinely cost nothing that
        # tick. Medianing only over records where the path appeared gave
        # each path its own support: a child that exists only in the one
        # cold tick (sim.arrive/sim.arrive.create — 50k creates at
        # tick 0, none after) medianed to its cold-tick cost while its
        # every-tick parent medianed to ~0, printing a tree where a
        # child "takes" 5,884 ms inside a 0.025 ms parent (ISSUE 11).
        # With one shared support per record, a sequential child's p50
        # can never exceed its parent's (parallel fan-outs can still sum
        # children past the parent's wall time — that is real
        # concurrency, not an aggregation artifact).
        per_rec: list[dict[str, float]] = []

        def walk(name: str, node: dict, prefix: str, acc: dict):
            path = f"{prefix}/{name}" if prefix else name
            acc[path] = node["ms"]
            for child_name, child in node.get("children", {}).items():
                walk(child_name, child, path, acc)

        for rec in self.records:
            acc: dict[str, float] = {}
            for name, node in rec["tree"].items():
                walk(name, node, "", acc)
            per_rec.append(acc)
        all_paths = sorted({p for acc in per_rec for p in acc})
        tree_p50 = {
            path: round(
                float(np.median([acc.get(path, 0.0) for acc in per_rec])), 3
            )
            for path in all_paths
        }
        commits: dict[str, int] = {}
        for rec in self.records:
            for key, n in rec["commits"].items():
                commits[key] = commits.get(key, 0) + n
        self_tot: dict[str, list[float]] = {}
        for rec in self.records:
            for name, row in rec["self_ms_by_name"].items():
                self_tot.setdefault(name, [0, 0.0])
                self_tot[name][0] += row["count"]
                self_tot[name][1] += row["self_ms"]
        top = sorted(self_tot.items(), key=lambda kv: -kv[1][1])[: self.top_n]
        counters: dict[str, float] = {}
        for rec in self.records:
            for name, d in rec["counters"].items():
                counters[name] = round(counters.get(name, 0.0) + d, 3)
        per_tick_phases = [self.phases_ms(r) for r in self.records]
        return {
            "ticks": len(self.records),
            "spans_total": sum(r["spans"] for r in self.records),
            "spans_dropped": sum(r["spans_dropped"] for r in self.records),
            "tick_span_p50_ms": round(
                float(np.median([r["total_ms"] for r in self.records])), 3
            ),
            "span_tree_p50_ms": tree_p50,
            "phases_p50_ms": {
                phase: round(
                    float(np.median([p.get(phase, 0.0) for p in per_tick_phases])),
                    3,
                )
                for phase in (*PHASE_SPANS, "other")
            },
            # the reconciliation handle: per-tick sum of span-derived
            # phases, medianed — must track timing["tick_p50_ms"] (±5%),
            # since both decompose the same tick from the same spans
            "phase_sum_p50_ms": round(
                float(
                    np.median([sum(p.values()) for p in per_tick_phases])
                ),
                3,
            ),
            "top_self_ms": [
                {"name": name, "count": n, "self_ms": round(slf, 3)}
                for name, (n, slf) in top
            ],
            "commits": dict(sorted(commits.items())),
            "commits_total": sum(commits.values()),
            "counters": dict(sorted(counters.items())),
        }
