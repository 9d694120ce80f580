"""The fast-path binder: eligibility → route → tight fit → guard → bind.

One :class:`FastPathAdmitter` sits between arrival and the periodic
solve. The scheduler re-bases it after every batch tick
(:meth:`begin_window`: the solve's post-backfill residual plus the
unplaced-gang backlog to protect); between ticks, each interactive
arrival gets one :meth:`admit` call:

1. **eligibility** — the pod's priority class (PR-9 table, the same
   resolution the policy engine uses) must be in
   ``AdmissionConfig.interactive_classes`` and its gang small enough
   (``nodes ≤ max_gang_nodes``): production/system singles and small
   gangs ride the fast path, bulk batch work stays on the solve;
2. **route** — the single-job form of the PR-10 shard router: with a
   shard plan attached, the gang goes WHOLE to the one shard of its
   partition with the most feasible residual capacity (ties to the
   lowest shard id — deterministic), so fast-path gangs keep the same
   no-shard-straddling contract the batch fan-out enforces;
3. **tight fit** — feasible nodes ordered tightest-fit first (least cpu
   headroom after placement), exactly backfill's node-choice rule;
4. **no-delay guard** — a take is rejected if it would shrink the
   feasible node set of any protected (unplaced, equal-or-higher-class,
   currently-feasible) gang below its size: the fast path can never
   delay the batch backlog's feasible starts. The guard bookkeeping is
   line-for-line the ``policy.engine.PlacementPolicy.backfill`` guard —
   the fuzzed oracle in tests/test_admission.py holds the two together;
5. **bind** — the caller commits the store write; on a commit conflict
   the reservation rolls back (:meth:`rollback`).

Misses fall through to the normal pending scan untouched, and the
periodic solve may later preempt fast-path placements under the
existing bounded-preemption rules — a fast-path pod is an ordinary
bound pod from the batch tick's point of view.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from slurm_bridge_tpu_torch.admission.residual import ResidualView
from slurm_bridge_tpu_torch.obs.metrics import REGISTRY, Histogram
from slurm_bridge_tpu_torch.obs.tracing import TRACER
from slurm_bridge_tpu_torch.policy.classes import (
    DEFAULT_CLASSES,
    ClassTable,
    PriorityClass,
)
from slurm_bridge_tpu_torch.solver.snapshot import job_scalars

_attempts = REGISTRY.counter(
    "sbt_admission_attempts_total",
    "fast-path admission attempts (eligible arrivals)",
)
_binds = REGISTRY.counter(
    "sbt_admission_binds_total", "arrivals bound via the fast path"
)
_misses = REGISTRY.counter(
    "sbt_admission_misses_total",
    "fast-path misses that fell through to the batch tick, by reason",
)
_latency = REGISTRY.histogram(
    "sbt_admission_latency_seconds",
    "wall time of one fast-path admission attempt",
    buckets=Histogram.FAST_BUCKETS,
)


@dataclass(frozen=True)
class AdmissionConfig:
    """Declarative streaming-admission knobs — frozen + tuple-valued so
    a :class:`~slurm_bridge_tpu_torch.sim.harness.Scenario` can carry one."""

    #: classes whose arrivals ride the fast path (PR-9 table names)
    interactive_classes: tuple[str, ...] = ("production", "system")
    #: "singles and small gangs": a gang asking for more nodes than this
    #: goes to the batch solve (big gangs want the solver's packing)
    max_gang_nodes: int = 4
    #: class table used when no policy engine is attached (a scheduler
    #: WITH a policy resolves through the policy's own table, so the two
    #: can never disagree about a pod's class)
    classes: tuple[PriorityClass, ...] = DEFAULT_CLASSES
    default_class: str = "batch"
    #: distinct nodes tried per shard before giving up — backfill's
    #: ``backfill_node_tries`` for the fast path
    node_tries: int = 8
    #: sim-harness knob: arrivals in the first N ticks are excluded from
    #: the latency scorecard (no window exists before the first solve
    #: and no virtual node is ready before the first mirror — cold-start
    #: placement is the batch tick's job, the latency SLO is steady-state)
    latency_warmup_ticks: int = 2


@dataclass(frozen=True)
class AdmitResult:
    """One admission attempt's outcome."""

    eligible: bool
    #: chosen node names (placement hint) when bound, else ()
    hint: tuple[str, ...] = ()
    #: miss reason when eligible but not bound: no_window | not_ready |
    #: unknown_partition | no_fit | guard | conflict
    reason: str = ""

    @property
    def bound(self) -> bool:
        return bool(self.hint)


class FastPathAdmitter:
    """Streaming-admission state for one scheduler."""

    def __init__(self, config: AdmissionConfig | None = None, *, policy=None):
        self.config = config or AdmissionConfig()
        self.table: ClassTable = (
            policy.table
            if policy is not None
            else ClassTable(
                self.config.classes, default=self.config.default_class
            )
        )
        self._interactive_ranks = {
            self.table.rank_of(self.table.by_name[name])
            for name in self.config.interactive_classes
            if name in self.table.by_name
        }
        self.view = ResidualView()
        #: serializes every window/deduction mutation: ``admit()`` is an
        #: ARRIVAL-time entry (event-driven, off the tick thread in a
        #: real bridge), so the residual debits, guard bookkeeping and
        #: deduction map must not race the tick's prune/subtract/re-base
        #: seams. Lock ordering: this lock is taken OUTSIDE the store
        #: lock (admit's bind and the prune's column reads nest inside).
        self.lock = threading.Lock()
        #: shard plan of the window (None = monolithic tick)
        self._plan = None
        #: protected unplaced gangs, backfill-shaped records:
        #: {need, rank, d, part(code), req, mask, count}
        self.protected: list[dict] = []
        #: pod name → (hint names, per-shard demand vec) for fast-path
        #: binds not yet visible in the agent inventory — the batch solve
        #: subtracts these so it cannot double-claim the capacity
        self.deductions: dict[str, tuple[tuple[str, ...], np.ndarray]] = {}
        #: (window snapshot ref) → node name → position memo, built
        #: lazily on the first inventory rebase of a window
        self._pos_memo: tuple | None = None
        #: whether a provider inventory report may currently maintain
        #: the window. Flipped UNDER :attr:`lock`, in lockstep with the
        #: window itself: ``begin_window`` (a solve re-base) forbids it
        #: — a provider probes BEFORE converging its submits, so on
        #: solve ticks its view predates the tick's binds — and the
        #: scheduler re-allows it on ticks no solve re-based the window
        #: (idle / steady-skip). Because gate and re-base are evaluated
        #: under the same lock as the window install, a probe racing a
        #: concurrent solve either lands before ``begin_window`` (and
        #: is overwritten by the fresh residual) or after (and is
        #: refused) — never on top of a fresher window.
        self._inventory_ok = False
        # ---- run accounting (scheduler/harness observability) ----
        self.attempts_total = 0
        self.binds_total = 0
        self.misses: dict[str, int] = {}
        #: inventory re-bases that actually moved the view (ROADMAP
        #: streaming-admission follow-up c)
        self.inventory_rebases = 0

    # ---- eligibility ----

    def eligibility_rank(self, labels, demand) -> int | None:
        """The pod's class rank when fast-path eligible, else None."""
        if demand is None:
            return None
        if max(1, demand.nodes) > self.config.max_gang_nodes:
            return None
        cls = self.table.resolve(labels)
        rank = self.table.rank_of(cls)
        return rank if rank in self._interactive_ranks else None

    # ---- the per-tick window ----

    def begin_window(self, snapshot, free_after, backlog, *, plan=None) -> None:
        """Re-base the residual view on a fresh solve and rebuild the
        protected-gang set. ``backlog`` is the tick's unplaced pending
        work as ``(demand, class_rank)`` pairs; only multi-shard gangs
        feasible NOW are protected — exactly backfill's contract (a gang
        already infeasible cannot be delayed by a fast-path take).
        Serialized against concurrent arrivals via :attr:`lock`. The span
        ``admission.window`` counts the ``protected`` gangs and the
        in-flight ``deductions`` carried over into the new window."""
        with TRACER.span("admission.window") as span, self.lock:
            self._begin_window_locked(snapshot, free_after, backlog, plan)
            span.count("protected", len(self.protected))
            span.count("deductions", len(self.deductions))

    def _begin_window_locked(self, snapshot, free_after, backlog, plan) -> None:
        self._inventory_ok = False
        self.view.begin_window(snapshot, free_after)
        self._plan = plan
        self.protected = []
        for demand, rank in backlog:
            cpu, mem, gpu, part, req, need, _prio = job_scalars(
                demand, snapshot
            )
            if need <= 1 or part < 0:
                continue
            d = np.asarray([cpu, mem, gpu], np.float32)
            mask = self.view.feasible(d, part, req)
            count = int(mask.sum())
            if count < need:
                continue
            self.protected.append(
                {
                    "need": need,
                    "rank": rank,
                    "d": d,
                    "part": part,
                    "req": int(req),
                    "mask": mask,
                    "count": count,
                }
            )

    def allow_inventory_rebase(self) -> None:
        """Re-open the window to inventory maintenance — called by the
        scheduler on ticks NO solve re-based the window (the idle early
        return and the steady-bind skip). Lock-serialized against
        ``begin_window``, which forbids it again (see
        :attr:`_inventory_ok` for the race analysis)."""
        with self.lock:
            self._inventory_ok = True

    def rebase_from_inventory(self, nodes, *, skip_nodes=None) -> int:
        """Maintain the window from a periodic inventory probe (ROADMAP
        streaming-admission follow-up c): an IDLE cluster re-bases only
        on solve ticks, so capacity freed by completions stayed invisible
        to the fast path until the next solve — which, with nothing
        pending, never comes. The provider's per-tick Nodes probe already
        carries the truth; this folds it into the residual view:

        - each reported node's free capacity replaces the view's row,
          MINUS the outstanding in-flight fast-bind deductions on that
          node (those binds are not agent-visible yet);
        - nodes in ``skip_nodes`` keep the window's own (conservative)
          value untouched — the scheduler passes the hint nodes of
          store-BOUND pods whose submission has not reached the agent
          yet (``job_ids`` still empty): the agent reports their
          capacity free, but the window's solve residual already
          committed it, and raising those rows would let the fast path
          double-claim a batch bind in flight;
        - protected-gang masks/counts recompute against the refreshed
          free, so the no-delay guard keeps judging current feasibility.

        Gated by :attr:`_inventory_ok` UNDER the lock (set by
        :meth:`allow_inventory_rebase`, cleared by ``begin_window``), so
        a probe racing a concurrent solve can never clobber a fresher
        window. Returns the number of view rows that moved.
        """
        with self.lock:
            view = self.view
            if not view.ready or not self._inventory_ok:
                return 0
            snap = view.snapshot
            memo = self._pos_memo
            if memo is None or memo[0] is not snap:
                memo = self._pos_memo = (
                    snap, {n: i for i, n in enumerate(snap.node_names)}
                )
            idx = memo[1]
            ded: dict[str, np.ndarray] = {}
            for _nm, (hint, d) in self.deductions.items():
                for h in hint:
                    prev = ded.get(h)
                    ded[h] = d.copy() if prev is None else prev + d
            touched = 0
            for nd in nodes:
                if skip_nodes and nd.name in skip_nodes:
                    continue
                pos = idx.get(nd.name)
                if pos is None:
                    continue
                if nd.schedulable:
                    f = np.asarray(
                        [nd.free_cpus, nd.free_memory_mb, nd.free_gpus],
                        np.float32,
                    )
                else:
                    f = np.zeros(3, np.float32)
                sub = ded.get(nd.name)
                if sub is not None:
                    f = np.maximum(f - sub, 0.0)
                if not np.array_equal(view.free[pos], f):
                    view.free[pos] = f
                    touched += 1
            if touched:
                self.inventory_rebases += 1
                for g in self.protected:
                    mask = view.feasible(g["d"], g["part"], g["req"])
                    g["mask"] = mask
                    g["count"] = int(mask.sum())
        return touched

    # ---- in-flight deduction bookkeeping ----

    def drop_deduction(self, name: str) -> None:
        self.deductions.pop(name, None)

    def deduction_signature(self) -> tuple:
        """Solve-memo key component: the in-flight fast binds the batch
        solve subtracts (a dropped deduction must invalidate the warm
        start even when nothing else moved)."""
        with self.lock:
            return tuple(
                (n, hint, d.tobytes())
                for n, (hint, d) in sorted(self.deductions.items())
            )

    def deductions_copy(self) -> dict:
        """A consistent snapshot of the in-flight deductions for the
        solve to subtract — the solve must not iterate the live map
        while an arrival commits into it."""
        with self.lock:
            return dict(self.deductions)

    # ---- the admission attempt ----

    def _route(self, fit_mask: np.ndarray, partition: str, need: int):
        """Candidate node positions for one gang — the single-job form
        of the PR-10 shard router: the gang goes whole to the one shard
        of its partition with the most feasible residual capacity."""
        plan = self._plan
        if plan is None:
            return np.nonzero(fit_mask)[0]
        sids = plan.part_shards.get(partition)
        if not sids:
            return np.nonzero(fit_mask)[0]
        best = None
        best_key = None
        for sid in sids:
            members = plan.members.get((sid, partition))
            if members is None:
                continue
            pos = members[fit_mask[members]]
            key = (pos.size >= need, int(pos.size), -sid)
            if best_key is None or key > best_key:
                best_key, best = key, pos
        if best is None:
            return np.nonzero(fit_mask)[0]
        return np.sort(best)

    # NOTE: miss_only / admit / note_bound / rollback are called by the
    # scheduler's arrival entry UNDER :attr:`lock` (one critical section
    # covering reserve → store bind → commit-or-rollback); they do not
    # re-acquire it themselves.

    def miss_only(self, reason: str) -> str:
        """Count an attempt that missed before reaching :meth:`admit`
        (e.g. the caller's virtual-node ready check)."""
        self.attempts_total += 1
        _attempts.inc()
        return self._miss(reason)

    def admit(self, demand, rank: int):
        """One guarded admission attempt against the residual view.

        Returns ``(node_names, miss_reason, token)`` — names empty on a
        miss. On success the residual is already debited and ``token``
        holds the reservation; the CALLER commits the store bind, then
        either :meth:`note_bound` (committed) or :meth:`rollback`
        (conflict) with that token.
        """
        self.attempts_total += 1
        _attempts.inc()
        if not self.view.ready:
            return (), self._miss("no_window"), None
        snapshot = self.view.snapshot
        cpu, mem, gpu, part, req, need, _prio = job_scalars(demand, snapshot)
        if part < 0:
            return (), self._miss("unknown_partition"), None
        # admit at the workload manager's INTEGRAL per-node granularity:
        # Slurm allocates whole cpus/MBs per node (ceil of the gang's
        # per-shard spread), while the solver's float model divides
        # evenly. Rounding up keeps the residual view truthful against
        # allocations the window cannot see yet — and a ceil-accept is
        # strictly conservative, so it is also a float-model (guarded
        # backfill) accept.
        d = np.ceil(np.asarray([cpu, mem, gpu], np.float32))
        free = self.view.free
        fit_mask = self.view.feasible(d, part, req)
        cands = self._route(fit_mask, demand.partition, need)
        if cands.size < need:
            return (), self._miss("no_fit"), None
        # tightest fit first: least cpu headroom after placement — the
        # backfill node-choice rule, stable so ties stay deterministic
        cands = cands[np.argsort(free[cands, 0] - d[0], kind="stable")]
        chosen: list[int] = []
        hits: list = []  # (protected gang, node) feasibility reductions
        guard_blocked = False
        limit = max(need, self.config.node_tries)
        for n in cands[:limit].tolist():
            # the no-delay guard — policy.backfill's predicate with one
            # strengthening: feasibility BOOKKEEPING runs for EVERY
            # protected gang (a higher-class candidate's takes update a
            # lower-class gang's mask too, so counts never go stale),
            # while the VETO stays class-scoped — only an equal-or-
            # higher-class gang that is still feasible may block a take.
            # Strictly more conservative than backfill's incremental
            # masks, so every fast accept is still a backfill accept.
            bad = False
            n_hits = []
            for g in self.protected:
                if not g["mask"][n]:
                    continue
                if not (free[n] - d >= g["d"]).all():
                    if (
                        g["rank"] >= rank
                        and g["count"] >= g["need"]  # dead gangs don't veto
                        and g["count"] - 1 < g["need"]
                    ):
                        bad = True
                        break
                    n_hits.append(g)
            if bad:
                guard_blocked = True
                continue
            free[n] -= d
            for g in n_hits:
                g["mask"] = g["mask"].copy()
                g["mask"][n] = False
                g["count"] -= 1
            hits.extend((g, n) for g in n_hits)
            chosen.append(n)
            if len(chosen) == need:
                break
        if len(chosen) < need:
            # all-or-nothing: roll the tentative takes back (restoring
            # free restores exactly the feasibility the takes removed)
            for n in chosen:
                free[n] += d
            for g, n in hits:
                g["mask"] = g["mask"].copy()
                g["mask"][n] = True
                g["count"] += 1
            return (), self._miss("guard" if guard_blocked else "no_fit"), None
        self.view.binds_since_window += 1
        names = tuple(snapshot.node_names[i] for i in chosen)
        return names, "", (chosen, d, hits)

    def note_bound(self, name: str, hint: tuple[str, ...], token) -> None:
        """The store bind committed: remember the in-flight deduction
        until the pod's submission is visible agent-side."""
        _chosen, d, _hits = token
        self.binds_total += 1
        _binds.inc()
        self.deductions[name] = (hint, d)

    def rollback(self, token) -> None:
        """The store bind conflicted: release the reservation — the
        residual free AND the protected-gang bookkeeping the takes
        decremented (restoring only free would leave the guard counting
        a still-feasible gang as partially starved for the rest of the
        window)."""
        chosen, d, hits = token
        self.view.release(chosen, d)
        for g, n in hits:
            g["mask"] = g["mask"].copy()
            g["mask"][n] = True
            g["count"] += 1
        self._miss("conflict")

    def _miss(self, reason: str) -> str:
        self.misses[reason] = self.misses.get(reason, 0) + 1
        _misses.inc(reason=reason)
        return reason

    def observe_latency(self, seconds: float) -> None:
        _latency.observe(seconds)

    def stats(self) -> dict:
        """Deterministic run aggregates (scenario determinism section)."""
        return {
            "attempts": self.attempts_total,
            "binds": self.binds_total,
            "misses": dict(sorted(self.misses.items())),
            "inventory_rebases": self.inventory_rebases,
        }
