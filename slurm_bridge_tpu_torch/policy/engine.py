"""The placement policy engine — sits between the pending scan and the
solver (ISSUE 9 tentpole).

Policy OFF (``PlacementScheduler(policy=None)``, the default) is the
PR-8 behavior byte-for-byte: no reordering, no priority rewrite, the
whole incumbent set in the preemption pool, no backfill. Everything in
this module runs only when a :class:`PlacementPolicy` is attached.

Policy ON changes three things about a tick:

1. **Admission order** (:meth:`prepare`): pending pods are grouped by
   priority CLASS (descending) and ordered within a class by weighted
   dominant-resource fair share across tenants (``fairshare.FairShare``)
   — not raw priority-FIFO. The order is lowered into per-job *effective
   priorities* the solver admits by: dense integers
   ``class_rank * count + slot`` (exact in float32), so class dominance
   and the fair order survive the kernel's priority sort unchanged.
2. **Preemption pool** (:meth:`prepare`): only incumbents whose class is
   preemptible AND strictly below the highest pending class in their
   own partition may be displaced, and at most
   ``max_preemptions_per_tick`` of them (weakest first) join the
   re-solve — bounded churn. Everyone else keeps their allocation
   untouched (they are simply not in the batch). Pool incumbents occupy
   the TOP slots of their class band (weakest lowest), so equal-class
   newcomers can never displace them — only a higher class can — and
   the solver prefers displacing the numerically weakest.
3. **Backfill** (:meth:`backfill`): after the main solve, everything
   left unplaced — single-shard jobs AND whole gangs, placed
   all-or-nothing — is packed into the leftover fragmentation holes
   (smallest demand first, tightest-fit), guarded so no placement
   shrinks the feasible node set of any other unplaced
   equal-or-higher-class gang below its size — backfill never delays a
   higher-priority gang's feasible start.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from slurm_bridge_tpu_torch.policy.classes import (
    CLASS_LABEL,
    DEFAULT_CLASSES,
    TENANT_LABEL,
    ClassTable,
    PriorityClass,
)
from slurm_bridge_tpu_torch.policy.fairshare import FairShare, dominant_share

__all__ = [
    "CLASS_LABEL",
    "TENANT_LABEL",
    "PolicyConfig",
    "PlacementPolicy",
    "feasible_nodes",
]


def feasible_nodes(
    free: np.ndarray,
    partition_of: np.ndarray,
    features: np.ndarray,
    d: np.ndarray,
    part: int,
    req: int,
) -> np.ndarray:
    """The ONE node-feasibility rule placement second passes share: a
    node can host one shard of ``(d, part, req)`` iff it is in the
    partition, every resource axis fits ``free``, and it carries every
    required feature bit. Backfill's guard and the streaming-admission
    fast path (slurm_bridge_tpu_torch.admission) both call this, so the
    fast-path ≡ guarded-backfill oracle holds by construction on the
    fit half of the decision."""
    return (
        (partition_of == part)
        & ((free >= d).all(axis=1))
        & ((np.uint32(req) & ~features) == 0)
    )


@dataclass(frozen=True)
class PolicyConfig:
    """Declarative policy knobs — frozen + tuple-valued so a
    :class:`~slurm_bridge_tpu_torch.sim.harness.Scenario` can carry one."""

    classes: tuple[PriorityClass, ...] = DEFAULT_CLASSES
    default_class: str = "batch"
    #: (tenant, weight) quota table; missing tenants weigh 1.0
    tenant_weights: tuple[tuple[str, float], ...] = ()
    #: dominant-resource fair admission within a class (off = priority
    #: FIFO within the class, classes still dominate)
    fair_share: bool = True
    #: second-pass hole filling after the main solve
    backfill: bool = True
    #: churn bound: at most this many incumbents join the preemption
    #: pool per tick, weakest (lowest class, lowest priority) first
    max_preemptions_per_tick: int = 64
    #: backfill candidates examined per tick (smallest demand first)
    backfill_limit: int = 256
    #: distinct nodes tried per backfill candidate before giving up
    backfill_node_tries: int = 8


def _demand_vec(demand) -> tuple[float, float, float]:
    """One job's TOTAL (cpu, mem, gpu) ask — the fair-share charge."""
    if demand is None:
        return (1.0, 0.0, 0.0)
    from slurm_bridge_tpu_torch.core.arrays import array_len

    arr = array_len(demand.array) if demand.array else 1
    cpus = float(demand.total_cpus(arr))
    mem = float(demand.total_mem_mb(arr) or cpus * 1024.0)
    gpu = 0.0
    if demand.gres:
        parts = demand.gres.split(":")
        try:
            gpu = float(int(parts[-1].split("(")[0])) * max(1, demand.nodes)
        except ValueError:
            gpu = 0.0
    return (cpus, mem, gpu)


class PlacementPolicy:
    """One scheduler's policy state (fair-share usage persists across
    ticks; everything else is recomputed per tick)."""

    def __init__(self, config: PolicyConfig | None = None):
        self.config = config or PolicyConfig()
        self.table = ClassTable(
            self.config.classes, default=self.config.default_class
        )
        self.fair = FairShare(dict(self.config.tenant_weights))
        #: cluster capacity totals [cpu, mem, gpu] of the current tick
        self._totals = (1.0, 1.0, 1.0)
        #: per-pending-job (tenant, dominant share, class rank), aligned
        #: with the REORDERED pending list prepare() returned
        self._tick_jobs: list[tuple[str, float, int]] = []
        # ---- observability (the sim scorecard reads these) ----
        self.backfill_binds_total = 0
        self.pool_size_last = 0
        self.pool_excluded_last = 0
        self.backfill_candidates_last = 0
        self.backfill_binds_last = 0
        #: partition → MIN class rank among preemptible incumbents the
        #: bounded pool EXCLUDED this tick (explainability, ISSUE 15):
        #: an unplaced job of a strictly higher rank in that partition
        #: could have been helped by a bigger ``max_preemptions_per_tick``
        #: — the PREEMPTION_CAP attribution reads this
        self.pool_excluded_rank_by_part: dict[str, int] = {}
        #: fair-share usage changed since the last store save (PR-10:
        #: the ledger rides the WAL through a PolicyState singleton)
        self._usage_dirty = False

    # ---- tick lifecycle ----

    def begin_tick(self, nodes) -> None:
        """Capture cluster capacity totals (the DRF denominator)."""
        cpu = mem = gpu = 0.0
        for nd in nodes:
            cpu += nd.cpus
            mem += nd.memory_mb
            gpu += nd.gpus
        self._totals = (max(cpu, 1.0), max(mem, 1.0), max(gpu, 0.0))

    def _pod_meta(self, pod) -> tuple[PriorityClass, str, float, float]:
        """(class, tenant, dominant share, spec priority) for one
        schedulable pod (a scheduler ``_RowPod`` or anything with
        ``labels``/``demand``/``name``)."""
        labels = getattr(pod, "labels", None)
        cls = self.table.resolve(labels)
        tenant = (labels.get(TENANT_LABEL, "") if labels else "") or ""
        share = dominant_share(_demand_vec(pod.demand), self._totals)
        prio = float(pod.demand.priority) if pod.demand is not None else 0.0
        return cls, tenant, share, prio

    def prepare(
        self, pending: list, incumbents: list
    ) -> tuple[list, list, list[float]]:
        """The tick's admission order, preemption pool, and effective
        priorities.

        Returns ``(ordered_pending, pool_incumbents, priorities)`` with
        ``priorities`` aligned to ``ordered_pending + pool_incumbents``
        (the ``all_pods`` list the scheduler encodes).
        """
        cfg = self.config
        metas = [self._pod_meta(p) for p in pending]
        # class buckets, highest class first
        buckets: dict[int, list[int]] = {}
        for i, (cls, _t, _s, _p) in enumerate(metas):
            buckets.setdefault(self.table.rank_of(cls), []).append(i)
        order: list[int] = []
        for rank in sorted(buckets, reverse=True):
            idxs = buckets[rank]
            if cfg.fair_share:
                jobs = [
                    (metas[i][1], metas[i][2], metas[i][3], pending[i].name)
                    for i in idxs
                ]
                order.extend(idxs[k] for k in self.fair.order(jobs))
            else:
                order.extend(
                    sorted(idxs, key=lambda i: (-metas[i][3], pending[i].name))
                )

        # preemption pool: preemptible incumbents of a class strictly
        # below the highest pending class IN THEIR OWN PARTITION —
        # partition-blind eligibility would let a big partition's
        # harmless scavengers fill the churn-bounded pool while the
        # contended partition's displaceable incumbents stay untouchable
        # (deterministic ticks would then starve the gang forever)
        part_max_rank: dict[str, int] = {}
        for i, m in enumerate(metas):
            rank = self.table.rank_of(m[0])
            part = pending[i].partition
            if rank > part_max_rank.get(part, -1):
                part_max_rank[part] = rank
        eligible: list[tuple[tuple, int]] = []
        for i, inc in enumerate(incumbents):
            cls, _tenant, _share, prio = self._pod_meta(inc)
            rank = self.table.rank_of(cls)
            if cls.preemptible and rank < part_max_rank.get(
                inc.partition, -1
            ):
                eligible.append(((rank, prio, inc.name), i))
        eligible.sort(key=lambda e: e[0])
        cap = max(0, cfg.max_preemptions_per_tick)
        pool_idx = [i for _, i in eligible[:cap]]
        self.pool_size_last = len(pool_idx)
        self.pool_excluded_last = len(incumbents) - len(pool_idx)
        # cap-excluded ELIGIBLE incumbents, by partition (min rank) —
        # the PREEMPTION_CAP explainability signal: these could have
        # been displaced if the churn bound were higher
        self.pool_excluded_rank_by_part = {}
        for (rank, _prio, _name), i in eligible[cap:]:
            part = incumbents[i].partition
            cur = self.pool_excluded_rank_by_part.get(part)
            if cur is None or rank < cur:
                self.pool_excluded_rank_by_part[part] = rank
        pool = [incumbents[i] for i in pool_idx]

        # effective priorities: dense per-band integers, exact in float32
        # (band = rank*count + slot; bands never overlap). Pool
        # incumbents occupy the TOP slots of their class band — weakest
        # (highest pool index) lowest — so every same-class pending sits
        # strictly below every same-class incumbent (only a higher CLASS
        # can displace), while within the pool the numerically weakest
        # incumbent is the one the solver prefers to displace. Pending
        # slots start below each band's incumbent block.
        count = len(order) + len(pool) + 2
        pool_ranks = [
            self.table.rank_of(self._pod_meta(inc)[0]) for inc in pool
        ]
        inc_count: dict[int, int] = {}
        for r in pool_ranks:
            inc_count[r] = inc_count.get(r, 0) + 1
        # pool is sorted weakest-first; strongest gets the band top
        inc_eff = [0.0] * len(pool)
        seen: dict[int, int] = {}
        for i in range(len(pool) - 1, -1, -1):
            r = pool_ranks[i]
            inc_eff[i] = float(r * count + (count - 1 - seen.get(r, 0)))
            seen[r] = seen.get(r, 0) + 1
        eff = [0.0] * len(order)
        self._tick_jobs = []
        for pos, i in enumerate(order):
            cls, tenant, share, _prio = metas[i]
            rank = self.table.rank_of(cls)
            slot = count - 2 - inc_count.get(rank, 0) - min(pos, count - 3)
            eff[pos] = float(rank * count + max(slot, 0))
            self._tick_jobs.append((tenant, share, rank))
        return [pending[i] for i in order], pool, eff + inc_eff

    def note_admitted(self, job_indices) -> None:
        """Charge fair-share usage for the pending jobs the solver (or
        backfill) admitted this tick — indices into the REORDERED
        pending list."""
        for j in job_indices:
            if 0 <= j < len(self._tick_jobs):
                tenant, share, _rank = self._tick_jobs[j]
                self.fair.charge(tenant, share)
                self._usage_dirty = True

    def charge_admission(self, labels, demand) -> None:
        """Fair-share charge for ONE pod admitted outside the batch tick
        (the streaming-admission fast path). Uses the capacity totals of
        the last ``begin_tick`` — before any tick has run there is no
        denominator, and charging against the (1,1,1) placeholder would
        wildly overcharge, so the pre-first-tick window charges nothing
        (the batch tick it falls back to would not have admitted yet
        either)."""
        if self._totals == (1.0, 1.0, 1.0):
            return
        tenant = (labels.get(TENANT_LABEL, "") if labels else "") or ""
        share = dominant_share(_demand_vec(demand), self._totals)
        self.fair.charge(tenant, share)
        self._usage_dirty = True

    # ---- durable fair share (PR-10, ROADMAP policy follow-up) ----

    def load_from_store(self, store) -> None:
        """Hydrate the fair-share ledger from the PolicyState singleton
        (restored by WAL replay on a restarted bridge). Missing object =
        fresh start — exactly the pre-PR-10 behavior."""
        from slurm_bridge_tpu_torch.bridge.objects import PolicyState

        obj = store.try_get(PolicyState.KIND, PolicyState.FAIRSHARE_NAME)
        if obj is not None:
            self.fair.usage = {k: float(v) for k, v in obj.usage.items()}

    def save_to_store(self, store) -> None:
        """Persist the ledger when (and only when) an admission charged
        it this tick — a no-admission tick writes NOTHING, keeping the
        steady-state zero-writes discipline intact. The write is an
        ordinary store commit, so WAL persistence picks it up through
        the same ``changes_since`` path as every other kind."""
        if not self._usage_dirty:
            return
        from slurm_bridge_tpu_torch.bridge.objects import Meta, PolicyState
        from slurm_bridge_tpu_torch.bridge.store import AlreadyExists, NotFound

        usage = dict(self.fair.usage)

        def record(obj):
            obj.usage = dict(usage)
            obj.generation += 1

        try:
            store.mutate(
                PolicyState.KIND, PolicyState.FAIRSHARE_NAME, record,
                site="policy.fairshare",
            )
        except NotFound:
            try:
                store.create(
                    PolicyState(
                        meta=Meta(name=PolicyState.FAIRSHARE_NAME),
                        usage=usage,
                        generation=1,
                    ),
                    site="policy.fairshare",
                )
            except AlreadyExists:  # racing writer: its value is newer
                pass
        self._usage_dirty = False

    def class_rank_of_job(self, j: int) -> int:
        """Class rank of reordered pending job ``j`` (default rank when
        unknown — direct solver callers without a prepare pass)."""
        if 0 <= j < len(self._tick_jobs):
            return self._tick_jobs[j][2]
        return self.table.rank_of(self.table.default)

    # ---- backfill ----

    def backfill(
        self, snapshot, batch, placement, n_pending: int, *, rank_of=None
    ) -> list[tuple[int, int]]:
        """Second-pass hole filling after the main solve.

        ``rank_of`` (optional) maps a batch job index to its class rank;
        the default reads the engine's own reordered-pending table. The
        sharded executor passes a shard-local → global translation here
        — per-shard batches index their own job lists, not the tick's.

        Everything the solve left unplaced gets one exact, bounded
        second chance against ``placement.free_after``: smallest total
        demand first, tightest-fit node choice, gangs all-or-nothing
        (the policy-side analogue of the auction's in-engine ``repair``
        — which approximate configs turn off — with the class guard the
        engine cannot have). The guard: no assignment may shrink the
        feasible node set of another unplaced equal-or-higher-class
        gang below its size — backfill never delays a higher-priority
        gang's feasible start. Gangs already infeasible *now* cannot be
        delayed by this pass and are not guarded.

        Returns ``(shard_row, node_index)`` assignments.
        """
        cfg = self.config
        if rank_of is None:
            rank_of = self.class_rank_of_job
        self.backfill_candidates_last = 0
        self.backfill_binds_last = 0
        unplaced = ~placement.placed & (batch.job_of >= 0) & (
            batch.job_of < n_pending
        )
        rows = np.nonzero(unplaced)[0]
        if rows.size == 0:
            return []
        free = placement.free_after.copy()
        feats = snapshot.features
        parts = snapshot.partition_of

        def feas_mask(d, part, req):
            return feasible_nodes(free, parts, feats, d, part, req)

        # one record per FULLY-unplaced gang (a partially-placed gang's
        # stragglers are dead this tick — the engines admit gangs
        # all-or-nothing, so leftovers only exist transiently)
        by_gang: dict[int, list[int]] = {}
        for r in rows.tolist():
            by_gang.setdefault(int(batch.gang_id[r]), []).append(r)
        cands: list[dict] = []
        for g, g_rows in sorted(by_gang.items()):
            r0 = g_rows[0]
            part = int(batch.partition_of[r0])
            if part < 0:
                continue
            cands.append(
                {
                    "rows": g_rows,
                    "need": len(g_rows),
                    "rank": rank_of(int(batch.job_of[r0])),
                    "d": batch.demand[r0],
                    "part": part,
                    "req": int(batch.req_features[r0]),
                }
            )
        # masks only for multi-shard gangs — singles never read theirs,
        # and a full-cluster mask per candidate is real vector work at
        # 10k nodes; the placement loop recomputes candidate fits fresh
        for c in cands:
            if c["need"] > 1:
                c["mask"] = feas_mask(c["d"], c["part"], c["req"])
                c["count"] = int(c["mask"].sum())
        # protected set: gangs feasible NOW (their start must survive)
        protected = [c for c in cands if c["need"] > 1 and c["count"] >= c["need"]]
        cands.sort(
            key=lambda c: (float(c["d"][0]) * c["need"], c["rows"][0])
        )
        cands = cands[: cfg.backfill_limit]
        self.backfill_candidates_last = len(cands)

        out: list[tuple[int, int]] = []
        for c in cands:
            d, part, req, need, rank = (
                c["d"], c["part"], c["req"], c["need"], c["rank"],
            )
            fit = feas_mask(d, part, req)
            nodes = np.nonzero(fit)[0]
            if nodes.size < need:
                continue
            # tightest fit first: least cpu headroom after placement
            nodes = nodes[np.argsort(free[nodes, 0] - d[0], kind="stable")]
            chosen: list[int] = []
            hits: list = []  # (gang record, node) feasibility reductions
            conflict = False
            limit = max(need, cfg.backfill_node_tries)
            for n in nodes[:limit].tolist():
                # guard: does taking n break another protected gang?
                bad = False
                n_hits = []
                for g in protected:
                    if g is c or g["rank"] < rank or not g["mask"][n]:
                        continue
                    if not (free[n] - d >= g["d"]).all():
                        if g["count"] - 1 < g["need"]:
                            bad = True
                            break
                        n_hits.append(g)
                if bad:
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
                # all-or-nothing: roll the tentative takes back. A hit
                # means (g, n) was feasible BEFORE the take and only the
                # capacity changed — restoring free[n] restores exactly
                # that, so the mask flips back without a cluster rescan.
                for n in chosen:
                    free[n] += d
                for g, n in hits:
                    g["mask"] = g["mask"].copy()
                    g["mask"][n] = True
                    g["count"] += 1
                continue
            if c in protected:
                protected.remove(c)  # it started; nothing left to guard
            out.extend((r, n) for r, n in zip(c["rows"], chosen))
        self.backfill_binds_last = len(out)
        self.backfill_binds_total += len(out)
        return out
