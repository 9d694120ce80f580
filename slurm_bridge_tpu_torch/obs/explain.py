"""Placement explainability — per-job "why" attribution + pressure ledger.

The scheduler has always been able to say *that* 42,994 of 500,000 jobs
are still pending, and (since PR-5/13) exactly how many milliseconds the
tick spent deciding so — but every unplaced job collapsed into one
interned string, ``"Unschedulable: insufficient capacity"``. This module
is the decision-attribution layer (ISSUE 15): a small CLOSED taxonomy of
structured reason codes, computed **vectorized from artifacts the hot
path already produces** — the solve's post-backfill residual
``free_after``, the encoder's capacity/feature columns, the shard
router's routing table, the reconcile pass's spill set, the policy
engine's admission order — never a per-job store probe at storm scale.

Reasons land in three sinks:

1. the pod's ``status.reason`` becomes ``Unschedulable: CODE: text``
   (events and ``kubectl describe`` parity preserved — the string is
   interned per code, so 43k unplaced pods share a handful of objects);
2. a per-tick **pressure ledger** (reason × partition × class × tenant
   counts + top-bottleneck attribution per shard) riding the flight
   record, the scenario JSON (``quality.wait_reasons``) and the live
   ``/debug/schedz`` zpage;
3. a per-job **decision trail** (``--explain <job>`` on the sim CLI)
   tracing one job through route → solve → backfill/reconcile → reason.

The taxonomy (primary code = FIRST matching rung of the ladder):

==================== =====================================================
``NO_READY_VNODE``   the partition has no ready virtual node (bind gate)
``NO_FEASIBLE_NODE`` no node in the partition can EVER host one shard
                     (total capacity / feature mask), or the partition is
                     unknown to the inventory
``GANG_ATOMIC``      members fit individually, but fewer than ``need``
                     structurally-eligible nodes exist — the gang can
                     never co-locate in this partition
``SHARD_SPILL``      the gang failed its routed shard, went to the
                     cross-shard reconcile pass, and stayed unplaced even
                     though the merged residual holds ``need`` feasible
                     nodes (the pass's guard/cap/tries blocked it)
``NO_DELAY_GUARD``   the job fits the post-solve residual RIGHT NOW, but
                     the backfill pass withheld it (no-delay guard /
                     bounded tries), or no second pass ran
``PREEMPTION_CAP``   infeasible now, but preemptible lower-class
                     incumbents in the partition were excluded from the
                     bounded preemption pool — a higher cap could free
                     capacity
``FAIRSHARE_DEFERRED`` infeasible now, and a same-class job with LOWER
                     raw priority placed in the same partition this tick
                     — fair-share banding deferred this one behind it
``FRAGMENTED``       aggregate free capacity in the partition covers the
                     job's total ask, but no ``need`` single nodes fit —
                     the capacity exists as dust
``PARTITION_FULL``   the partition genuinely lacks the aggregate free
                     capacity
``UNKNOWN``          no attribution available (remote-solver ticks,
                     explain off) — the pre-ISSUE-15 generic verdict
==================== =====================================================

The streaming-admission fast path keeps its own miss codes
(``no_window | not_ready | unknown_partition | no_fit | guard |
conflict`` — admission/fastpath.py); they describe an *attempt* that
fell through to the batch tick, not a pod's standing verdict, and ride
the same pressure ledger under ``admission_misses``.

Everything here is pure post-processing over NumPy arrays: attribution
never mutates a solve artifact, draws from an RNG, or reorders anything
— explain ON is digest-byte-identical to explain OFF by construction
(the bench-smoke ``profile_explain_overhead`` gate enforces it, ≤3%
paired-delta like the trace/WAL gates).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "CODES",
    "REASON_TEXT",
    "UNKNOWN",
    "reason_string",
    "code_of_reason",
    "UnplacedJob",
    "ExplainInputs",
    "PolicyContext",
    "attribute",
    "build_ledger",
    "merge_ledgers",
    "ExplainTrail",
    "SchedzPage",
    "SCHEDZ",
]

NO_READY_VNODE = "NO_READY_VNODE"
NO_FEASIBLE_NODE = "NO_FEASIBLE_NODE"
GANG_ATOMIC = "GANG_ATOMIC"
SHARD_SPILL = "SHARD_SPILL"
NO_DELAY_GUARD = "NO_DELAY_GUARD"
PREEMPTION_CAP = "PREEMPTION_CAP"
FAIRSHARE_DEFERRED = "FAIRSHARE_DEFERRED"
FRAGMENTED = "FRAGMENTED"
PARTITION_FULL = "PARTITION_FULL"
UNKNOWN = "UNKNOWN"

#: the closed taxonomy, ladder order (docs/observability.md mirrors it)
CODES = (
    NO_READY_VNODE,
    NO_FEASIBLE_NODE,
    GANG_ATOMIC,
    SHARD_SPILL,
    NO_DELAY_GUARD,
    PREEMPTION_CAP,
    FAIRSHARE_DEFERRED,
    FRAGMENTED,
    PARTITION_FULL,
    UNKNOWN,
)

REASON_TEXT = {
    NO_READY_VNODE: "no ready virtual node for the partition",
    NO_FEASIBLE_NODE: "no node in the partition can host one shard",
    GANG_ATOMIC: "members fit, but the gang cannot co-locate",
    SHARD_SPILL: "gang spilled its shard; cross-shard pass withheld it",
    NO_DELAY_GUARD: "fits the residual now; backfill withheld it",
    PREEMPTION_CAP: "displaceable incumbents excluded by the preemption cap",
    FAIRSHARE_DEFERRED: "deferred behind other tenants by fair share",
    FRAGMENTED: "capacity exists but no single node fits",
    PARTITION_FULL: "partition free capacity exhausted",
    UNKNOWN: "insufficient capacity",
}

#: interned ``Unschedulable: CODE: text`` strings — one object per
#: (code, detail), so a 43k-pod mark batch shares a handful of strings
#: exactly like the pre-ISSUE-15 single interned reason did
_REASON_MEMO: dict[tuple[str, str], str] = {}
_REASON_LOCK = threading.Lock()


def reason_string(code: str, detail: str = "") -> str:
    """The pod-facing reason for a code: ``Unschedulable: CODE: text``.

    ``detail`` (e.g. the partition name for NO_READY_VNODE) is folded
    into the interned key, preserving the old per-partition interning.
    """
    key = (code, detail)
    s = _REASON_MEMO.get(key)
    if s is None:
        text = REASON_TEXT.get(code, REASON_TEXT[UNKNOWN])
        if detail:
            text = f"{text} ({detail})"
        with _REASON_LOCK:
            s = _REASON_MEMO.setdefault(key, f"Unschedulable: {code}: {text}")
    return s


def code_of_reason(reason: str) -> str | None:
    """Parse the code back out of a pod reason string, or None when the
    reason is not an explain-formatted unschedulable verdict."""
    if not reason.startswith("Unschedulable: "):
        return None
    rest = reason[len("Unschedulable: "):]
    code = rest.split(":", 1)[0]
    return code if code in CODES else None


# --------------------------------------------------------------------------
# Vectorized attribution
# --------------------------------------------------------------------------


@dataclass
class UnplacedJob:
    """One unplaced pending job, captured from the solve's own batch
    rows — d/req/need come straight from the encoded columns, so the
    attribution judges exactly the model the solver judged."""

    j: int  #: tick job index (the scheduler's reordered pending order)
    partition: str
    d: np.ndarray  #: per-shard [cpu, mem, gpu] float demand
    need: int  #: shard count (gang size; 1 = single)
    req: int  #: required feature bits (uint32)
    shard: int = -1  #: routed shard id (-1 = monolithic tick)
    spilled: bool = False  #: reached the cross-shard reconcile pass


@dataclass
class ExplainInputs:
    """Everything attribution reads — all of it produced by the solve
    path anyway (the residual is the admission window's sibling; the
    capacity/feature columns are the encoder's)."""

    #: [N, 3] float residual free AFTER solve + backfill (+ reconcile)
    free: np.ndarray
    #: [N, 3] float total capacity
    capacity: np.ndarray
    #: [N] uint32 feature bitmasks
    features: np.ndarray
    #: partition name → member node positions on the global axis
    part_members: dict
    jobs: list[UnplacedJob] = field(default_factory=list)


@dataclass
class PolicyContext:
    """The policy-tick facts the FAIRSHARE_DEFERRED / PREEMPTION_CAP
    rungs read (None on policy-off ticks — those rungs never match)."""

    #: per pending job (reordered order): class rank
    ranks: list
    #: per pending job: raw spec priority (the pre-fair-share number)
    prios: list
    #: per pending job: partition name
    parts: list
    #: pending job indices that PLACED this tick (solver or backfill)
    placed: set
    fair_share: bool = True
    #: partition → min class rank among preemptible incumbents the
    #: bounded pool EXCLUDED this tick (policy.engine fills it)
    preempt_excluded: dict = field(default_factory=dict)


def _fairshare_floor(ctx: PolicyContext) -> dict[tuple[str, int], float]:
    """(partition, class rank) → min raw priority among PLACED jobs —
    the bar a FAIRSHARE_DEFERRED candidate must beat."""
    floor: dict[tuple[str, int], float] = {}
    for j in ctx.placed:
        key = (ctx.parts[j], ctx.ranks[j])
        p = float(ctx.prios[j])
        cur = floor.get(key)
        if cur is None or p < cur:
            floor[key] = p
    return floor


def attribute(
    inputs: ExplainInputs, policy_ctx: PolicyContext | None = None
) -> dict[int, str]:
    """Primary reason code per unplaced job index.

    Vectorized by demand SHAPE: jobs sharing (partition, demand, feature
    mask) — the common case under trace workloads — share one node-mask
    pass over the partition's member rows, so the cost is
    O(shapes × partition size + unplaced), not O(unplaced × nodes).
    """
    out: dict[int, str] = {}
    if not inputs.jobs:
        return out
    free, cap, feats = inputs.free, inputs.capacity, inputs.features
    groups: dict[tuple, list[UnplacedJob]] = {}
    for job in inputs.jobs:
        groups.setdefault(
            (job.partition, job.d.tobytes(), job.req), []
        ).append(job)
    fair_floor: dict[tuple[str, int], float] | None = None
    if policy_ctx is not None and policy_ctx.fair_share:
        fair_floor = _fairshare_floor(policy_ctx)
    #: partition → [cpu, mem, gpu] aggregate residual free (memoized —
    #: shapes within a partition share it)
    agg_free: dict[str, np.ndarray] = {}
    for (part, _dkey, req), jobs in sorted(
        groups.items(), key=lambda kv: (kv[0][0], kv[0][1], kv[0][2])
    ):
        m = inputs.part_members.get(part)
        if m is None or len(m) == 0:
            for job in jobs:
                out[job.j] = NO_FEASIBLE_NODE
            continue
        d = jobs[0].d
        feat_ok = (np.uint32(req) & ~feats[m]) == 0
        cap_count = int(((cap[m] >= d).all(axis=1) & feat_ok).sum())
        free_count = int(((free[m] >= d).all(axis=1) & feat_ok).sum())
        total_free = agg_free.get(part)
        if total_free is None:
            total_free = agg_free[part] = np.clip(
                free[m], 0.0, None
            ).sum(axis=0)
        for job in jobs:
            need = job.need
            if cap_count == 0:
                code = NO_FEASIBLE_NODE
            elif need > 1 and cap_count < need:
                code = GANG_ATOMIC
            elif free_count >= need:
                code = SHARD_SPILL if job.spilled else NO_DELAY_GUARD
            else:
                code = ""
                if policy_ctx is not None:
                    rank = policy_ctx.ranks[job.j]
                    excl = policy_ctx.preempt_excluded.get(part)
                    if excl is not None and rank > excl:
                        code = PREEMPTION_CAP
                    elif fair_floor is not None:
                        bar = fair_floor.get((part, rank))
                        if bar is not None and float(
                            policy_ctx.prios[job.j]
                        ) > bar:
                            code = FAIRSHARE_DEFERRED
                if not code:
                    code = (
                        FRAGMENTED
                        if bool((total_free >= d * need).all())
                        else PARTITION_FULL
                    )
            out[job.j] = code
    return out


# --------------------------------------------------------------------------
# Pressure ledger
# --------------------------------------------------------------------------


def build_ledger(rows: list[tuple[str, str, str, str, int]]) -> dict:
    """One tick's pressure ledger from per-pod attribution rows
    ``(code, partition, class, tenant, shard)``.

    The per-reason counts sum to the unplaced count BY CONSTRUCTION
    (one row per marked pod) — the acceptance invariant the explain
    tests pin. Cells are string-keyed (``code|partition|class|tenant``)
    so the ledger serializes into the flight record / scenario JSON
    without any schema machinery.
    """
    reasons: dict[str, int] = {}
    cells: dict[str, int] = {}
    shards: dict[int, dict[str, int]] = {}
    for code, part, cls, tenant, shard in rows:
        reasons[code] = reasons.get(code, 0) + 1
        key = f"{code}|{part}|{cls}|{tenant}"
        cells[key] = cells.get(key, 0) + 1
        if shard >= 0:
            sc = shards.setdefault(shard, {})
            sc[code] = sc.get(code, 0) + 1
    shard_top = {}
    for sid, counts in sorted(shards.items()):
        top = max(sorted(counts), key=lambda c: counts[c])
        shard_top[str(sid)] = {
            "top": top,
            "n": counts[top],
            "unplaced": sum(counts.values()),
        }
    return {
        "unplaced": len(rows),
        "reasons": dict(sorted(reasons.items())),
        "cells": dict(sorted(cells.items())),
        "shards": shard_top,
    }


def merge_ledgers(ledgers: list[dict], top_cells: int = 32) -> dict:
    """Run-level rollup of per-tick ledgers — the ``quality.wait_reasons``
    scorecard axis: job-ticks spent waiting, by reason (and the top
    reason × partition × class × tenant cells)."""
    reasons: dict[str, int] = {}
    cells: dict[str, int] = {}
    for led in ledgers:
        for code, n in led.get("reasons", {}).items():
            reasons[code] = reasons.get(code, 0) + n
        for key, n in led.get("cells", {}).items():
            cells[key] = cells.get(key, 0) + n
    top = sorted(cells.items(), key=lambda kv: (-kv[1], kv[0]))[:top_cells]
    return {
        "wait_reasons": dict(sorted(reasons.items())),
        "wait_reason_cells": dict(top),
    }


# --------------------------------------------------------------------------
# Decision trail (--explain <job>)
# --------------------------------------------------------------------------


class ExplainTrail:
    """One job's decision trail across the run.

    The scheduler (and the shard executor through it) appends one line
    per decision the TARGET pod flows through — routing, solve outcome,
    reconcile attempt, final reason, bind. All other pods cost nothing:
    every hook is guarded by one name compare.
    """

    def __init__(self, target: str):
        #: the sizecar pod name being traced
        self.target = target
        self.tick = 0  # stamped by the embedder (sim harness) per tick
        self.lines: list[str] = []

    def matches(self, name: str) -> bool:
        return name == self.target

    def add(self, stage: str, msg: str) -> None:
        self.lines.append(f"tick {self.tick}: [{stage}] {msg}")

    def render(self) -> str:
        header = f"decision trail for {self.target}"
        if not self.lines:
            return (
                f"{header}\n  (no decisions recorded — name the SIZECAR "
                "pod, e.g. <job>-sizecar, and check the job arrived)\n"
            )
        return header + "\n" + "\n".join(f"  {ln}" for ln in self.lines) + "\n"


# --------------------------------------------------------------------------
# /debug/schedz
# --------------------------------------------------------------------------


class SchedzPage:
    """The live scheduler-pressure zpage (``/debug/schedz``), fed one
    ledger per solve tick by every PlacementScheduler in the process —
    the tracez pattern (obs/tracing.py) applied to placement decisions."""

    def __init__(self, capacity: int = 64):
        self._ring: deque[tuple[int, dict]] = deque(maxlen=capacity)
        self._ticks = 0
        self._lock = threading.Lock()

    def publish(self, ledger: dict) -> None:
        with self._lock:
            self._ticks += 1
            self._ring.append((self._ticks, ledger))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._ticks = 0

    def render(self) -> str:
        with self._lock:
            recent = list(self._ring)
        lines = [f"schedz — placement pressure, last {len(recent)} solve ticks", ""]
        if not recent:
            lines.append("(no solve ticks recorded yet)")
            return "\n".join(lines) + "\n"
        agg = merge_ledgers([led for _, led in recent])
        lines.append(f"{'reason':22s} {'job-ticks':>10s}")
        for code, n in sorted(
            agg["wait_reasons"].items(), key=lambda kv: (-kv[1], kv[0])
        ):
            lines.append(f"{code:22s} {n:10d}")
        lines.append("")
        lines.append("top cells (reason|partition|class|tenant):")
        for key, n in list(agg["wait_reason_cells"].items())[:12]:
            lines.append(f"  {key:48s} {n:8d}")
        lines.append("")
        lines.append("recent ticks:")
        for seq, led in recent[-8:]:
            reasons = " ".join(
                f"{c}={n}" for c, n in sorted(led.get("reasons", {}).items())
            )
            lines.append(f"  #{seq}: unplaced={led.get('unplaced', 0)} {reasons}")
            for sid, top in sorted(led.get("shards", {}).items()):
                lines.append(
                    f"      shard {sid}: top={top['top']} "
                    f"({top['n']}/{top['unplaced']})"
                )
        return "\n".join(lines) + "\n"


#: process-wide page, mounted by obs.bootstrap next to /debug/tracez
SCHEDZ = SchedzPage()
