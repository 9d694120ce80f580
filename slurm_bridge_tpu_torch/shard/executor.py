"""Per-shard encode+solve fan-out + merge — the sharded tick engine.

One :class:`ShardExecutor` replaces the scheduler's monolithic
``_solve_local`` when sharding is on (``PlacementScheduler(shard=...)``):

1. **plan** — the partition/island shard layout (planner.py), cached
   while the partition layout is unchanged;
2. **route** — every pending job and incumbent to one shard (gangs
   whole, rank-aware locality score);
3. **encode** — per shard, against per-shard :class:`EncodedInventory` /
   :class:`JobRowCache` instances that carry across ticks exactly like
   the monolithic caches (identity window, column-diff delta, row
   reuse). The feature-code table is SHARED across shards — one bit
   space, assigned in serial shard order — so feature masks stay
   comparable when the reconcile pass mixes rows from different shards;
4. **solve** — per shard, fanned across a lazily-built worker pool (the
   same reuse-across-ticks / ``with_current_span`` discipline as the
   provider pod-sync pool). The per-shard router mirrors the monolithic
   one (greedy pin-through, indexed native below the dispatch floor)
   and runs the device auction on the executor's ``device`` — the card,
   unless asked for the CPU — and PROMOTES big shards to the multi-device
   sweep (``solver/sharded.py``) when the process solves on two or more
   devices; with fewer they stay on the single-device auction, and a
   device failure propagates instead of turning into a CPU solve;
5. **merge + reconcile** — per-shard placements map back to global job
   indices; per-shard residuals scatter onto the global node axis and
   gangs no shard could place get the cross-shard all-or-nothing pass
   (reconcile.py).

Determinism: routing, encode order, merge order and reconciliation are
all keyed on shard/job ids — the worker pool only changes WHEN a shard
solves, never what it returns, so any ``workers`` width produces the
same tick byte-for-byte (shard-smoke double-runs it).
"""

from __future__ import annotations

import logging
import threading
import time

import numpy as np

from slurm_bridge_tpu_torch.obs import explain as explain_mod
from slurm_bridge_tpu_torch.obs.metrics import REGISTRY, Histogram
from slurm_bridge_tpu_torch.obs.tracing import TRACER, with_current_span
from slurm_bridge_tpu_torch.shard.planner import (
    ShardConfig,
    ShardPlan,
    build_plan,
    plan_token,
    route_jobs,
    sub_partitions,
)
from slurm_bridge_tpu_torch.shard.reconcile import reconcile_gangs
from slurm_bridge_tpu_torch.solver import greedy_place
from slurm_bridge_tpu_torch.solver.encoder import EncodedInventory, JobRowCache
from slurm_bridge_tpu_torch.solver.snapshot import PAD_PARTITION, Placement, pad_batch

log = logging.getLogger("sbt.shard")

_shard_solve_seconds = REGISTRY.histogram(
    "sbt_shard_solve_seconds",
    "per-shard encode+solve wall time",
    buckets=Histogram.FAST_BUCKETS,
)
_shard_ticks = REGISTRY.counter(
    "sbt_shard_ticks_total", "sharded solve ticks executed"
)
_shard_count = REGISTRY.gauge(
    "sbt_shard_count", "shards in the current plan"
)
_shard_route = REGISTRY.counter(
    "sbt_shard_route_total", "per-shard solves by engine chosen"
)
_shard_jobs = REGISTRY.counter(
    "sbt_shard_jobs_routed_total", "jobs routed into shards"
)
_shard_reconcile = REGISTRY.counter(
    "sbt_shard_reconcile_gangs_total",
    "cross-shard reconcile outcomes, labeled placed|unplaced",
)


class _ShardState:
    """Cross-tick caches for one shard (mirrors the monolithic pair)."""

    __slots__ = ("inv", "rows", "solver")

    def __init__(self, feature_codes: dict):
        self.inv = EncodedInventory()
        # ONE feature-bit space across every shard: _rebuild grows this
        # dict in place and never replaces it, so sharing the object is
        # enough to keep masks comparable cross-shard
        self.inv.feature_codes = feature_codes
        self.rows = JobRowCache()
        self.solver = None  # DeviceSolver, built on first device route


class ShardExecutor:
    def __init__(
        self,
        config: ShardConfig | None = None,
        *,
        backend: str = "auto",
        auction_config=None,
        bucket: int = 1024,
        device=None,
    ):
        from slurm_bridge_tpu_torch.solver import AuctionConfig

        self.config = config or ShardConfig()
        self.backend = backend
        self.auction_config = auction_config or AuctionConfig()
        self.bucket = bucket
        #: where each shard's device auction runs: None is the card (or
        #: SBT_BACKEND=cpu), "cpu" the host (parallel/backend.py)
        self.device = device
        self._plan: ShardPlan | None = None
        self._plan_key: tuple | None = None
        self._states: dict[int, _ShardState] = {}
        self._feature_codes: dict[str, int] = {}
        #: per-tick sub-list cache: same global (nodes, partitions) lists
        #: (the scheduler's inventory_ttl window) reuse the same sub-list
        #: objects, so per-shard EncodedInventory identity hits fire.
        #: Holds the list objects themselves (identity-compared) — a bare
        #: id() key could false-hit when a freed list's address is
        #: recycled and silently serve last tick's inventory
        self._sub_cache: tuple[object, object, dict] | None = None
        self._pool = None
        self._pool_lock = threading.Lock()
        #: features-tuple → folded uint32 mask, invalidated when the
        #: shared code table grows (reconcile's idle-shard fold)
        self._feat_memo: dict[tuple, int] = {}
        self._feat_memo_token = -1
        #: device solves serialize — one accelerator, many shards
        self._device_lock = threading.Lock()
        # ---- per-tick observability (the scheduler/harness read these)
        self.last_encode_ms = 0.0
        self.last_shards_used = 0
        self.last_reconcile_attempts = 0
        self.last_reconcile_placed = 0
        self.last_routes: dict[str, int] = {}
        #: streaming-admission seam (ISSUE 12): when the scheduler asks
        #: (``capture_residual=True``), the merged post-backfill residual
        #: is packaged as (snapshot-like, residual, plan) — the window
        #: the fast path admits against between ticks. None otherwise:
        #: admission-off ticks pay nothing for the seam.
        self.last_window: tuple | None = None
        self._capture_residual = False
        #: explainability seam (ISSUE 15): the merged residual + one
        #: record per unplaced pending job (shard id, spill flag), what
        #: the scheduler's attribution pass reads. None when explain is
        #: off — explain-off ticks pay nothing for the seam.
        self.last_explain_inputs = None
        self._explain = False
        self._trail = None
        self._trail_job = -1
        #: (nodes list ref) → [N, 3] capacity columns memo (identity-
        #: stable node lists make steady generations rebuild nothing)
        self._explain_cap_memo: tuple | None = None
        #: (partitions ref, plan ref) → (partition_codes, partition_of)
        #: memo for the window snapshot build
        self._window_parts: tuple | None = None
        # ---- run aggregates (determinism/quality sections) ----
        self.ticks_total = 0
        self.reconcile_attempts_total = 0
        self.reconcile_placed_total = 0
        self.locality_sum = 0.0
        self.locality_count = 0
        #: fleet seam (ISSUE 17): when a FleetRuntime is attached, the
        #: greedy/native per-shard solves dispatch to the shard owner's
        #: solver sidecar over gRPC (byte-parity by construction); None
        #: keeps every solve in-process with zero overhead
        self.remote = None
        #: drift re-key probe cache: (base plan key, base plan) so the
        #: drained-fraction check doesn't rebuild the base plan per tick
        self._drift_probe: tuple | None = None

    # ---- plan + sub-inventory caching ----

    def _ensure_plan(self, partitions, nodes) -> ShardPlan:
        key = plan_token(partitions, nodes, self.config)
        drained = frozenset()
        if self.config.drift_rekey_fraction > 0:
            key, drained = self._drift_key(key, partitions, nodes)
        if self._plan is None or key != self._plan_key:
            self._plan = build_plan(partitions, nodes, self.config, drained)
            self._plan_key = key
            # a re-plan re-keys every shard's node set: drop shard states
            # whose ids fall away; survivors keep their caches (their
            # EncodedInventory rebuilds itself on the first refresh)
            self._states = {
                sid: st
                for sid, st in self._states.items()
                if sid < self._plan.num_shards
            }
            self._sub_cache = None
            _shard_count.set(self._plan.num_shards)
        return self._plan

    def _drift_key(self, base_key, partitions, nodes):
        """Drift re-key probe (ISSUE 17): when any BASE-plan shard's
        drained fraction exceeds ``drift_rekey_fraction``, the effective
        plan key grows the drained set — deterministic (a pure function
        of node states) and cheap (the base plan is cached on its own
        key; the per-shard check is one membership scan)."""
        from slurm_bridge_tpu_torch.shard.planner import drained_positions

        drained = drained_positions(nodes)
        if not drained:
            return base_key, frozenset()
        if self._drift_probe is None or self._drift_probe[0] != base_key:
            self._drift_probe = (
                base_key, build_plan(partitions, nodes, self.config)
            )
        base_plan = self._drift_probe[1]
        thresh = self.config.drift_rekey_fraction
        for shard in base_plan.shards:
            hit = sum(1 for pos in shard.node_idx if int(pos) in drained)
            if hit and hit / len(shard.node_idx) > thresh:
                return (base_key, tuple(sorted(drained))), drained
        return base_key, frozenset()

    def _sub_lists(self, plan, partitions, nodes, sid):
        if (
            self._sub_cache is None
            or self._sub_cache[0] is not nodes
            or self._sub_cache[1] is not partitions
        ):
            self._sub_cache = (nodes, partitions, {})
        cache = self._sub_cache[2]
        ent = cache.get(sid)
        if ent is None:
            shard = plan.shards[sid]
            ent = (
                [nodes[int(i)] for i in shard.node_idx],
                sub_partitions(plan, partitions, sid),
            )
            cache[sid] = ent
        return ent

    def _state(self, sid: int) -> _ShardState:
        st = self._states.get(sid)
        if st is None:
            st = self._states[sid] = _ShardState(self._feature_codes)
        return st

    # ---- per-shard mirror ownership (ISSUE 16) ----

    def mirror_groups(self, partitions: list[str]) -> list[list[str]]:
        """Partition names grouped by OWNING shard — the mirror-ownership
        split of the tentpole: each group is one shard's slice of the
        cluster, so the harness can classify/sweep/repair one shard's
        pods as a unit (and pipeline one group's status fetch under the
        next group's classification) instead of running a single global
        provider pass.

        Grouping is pure plan lookup: a partition belongs to the
        LOWEST shard id that holds any of its nodes (``part_shards`` is
        ascending); partitions the current plan does not know (mid-tick
        additions before a re-plan) own themselves as a pseudo-shard.
        Groups are the maximal CONTIGUOUS runs of the sorted input that
        share an owner, so the flattened output is byte-for-byte the
        sorted input — the digest-critical invariant: every side effect
        of the mirror (vnode registration uids, submit batches, status
        writes) happens in exactly the order the global pass produced,
        no matter how ownership fragments the name ordering. A shard
        whose partitions interleave with another's in name order simply
        owns several runs. With no plan yet — or sharding off — every
        partition lands in one group, which is exactly the global
        mirror pass."""
        ordered = sorted(partitions)
        if self._plan is None or not self._plan.part_shards:
            return [ordered] if ordered else []
        groups: list[list[str]] = []
        prev_owner: object = None
        for name in ordered:
            sids = self._plan.part_shards.get(name)
            owner: object = int(sids[0]) if sids else None
            if not groups or owner is None or owner != prev_owner:
                groups.append([name])
            else:
                groups[-1].append(name)
            prev_owner = owner
        return groups

    # ---- the sharded solve ----

    def solve(
        self,
        partitions,
        nodes,
        demands,
        all_pods,
        n_pending,
        *,
        priorities=None,
        demand_key=None,
        policy=None,
        deductions=None,
        capture_residual: bool = False,
        explain: bool = False,
        trail=None,
        trail_job: int = -1,
    ) -> tuple[dict[int, list[str]], list[int]]:
        """The sharded equivalent of ``PlacementScheduler._solve_local``:
        returns (global job index → assigned node names, global
        incumbent indices that lost their nodes).

        ``deductions`` (streaming admission) — in-flight fast-path
        binds, ``name → (hint node names, per-shard demand vec)`` —
        are subtracted from both the routing free view and each
        per-shard snapshot, so the fan-out can never double-claim
        fast-claimed capacity."""
        self._capture_residual = capture_residual
        self._explain = explain
        self._trail = trail
        self._trail_job = trail_job
        self.last_explain_inputs = None
        plan = self._ensure_plan(partitions, nodes)
        _shard_ticks.inc()
        self.ticks_total += 1
        # demand routing gets its own span (ISSUE 11 satellite): at the
        # 500k shape the free-array build + rank-aware routing is most of
        # the solve time the shard.encode/solve children did not explain
        with TRACER.span("scheduler.shard.route") as route_span:
            free = np.asarray(
                [
                    (nd.free_cpus, nd.free_memory_mb, nd.free_gpus)
                    if nd.schedulable
                    else (0.0, 0.0, 0.0)
                    for nd in nodes
                ],
                np.float32,
            )
            if deductions:
                for _nm, (hint, dvec) in sorted(deductions.items()):
                    for h in hint:
                        pos = plan.name_pos.get(h)
                        if pos is not None:
                            free[pos] -= dvec
            routed = route_jobs(
                plan, free, demands, all_pods, n_pending, priorities
            )
            route_span.count("jobs", len(all_pods))
            route_span.count("shards", len(routed))
            route_span.count("nodes", len(nodes))
            if trail is not None and trail_job >= 0:
                for sid in sorted(routed):
                    if trail_job in routed[sid]:
                        shard = plan.shards[sid]
                        trail.add(
                            "route",
                            f"routed whole to shard {sid} (partitions "
                            f"{','.join(shard.partitions)}, "
                            f"{len(shard.node_idx)} nodes)",
                        )
                        break
        _shard_jobs.inc(len(all_pods))
        self.last_shards_used = len(routed)
        if demand_key is None:
            demand_key = lambda pod: id(pod)  # noqa: E731 - test seam

        # ---- encode (serial: the shared feature table must grow in
        # deterministic shard order) ----
        t0 = time.perf_counter()
        work: list[tuple] = []
        for sid in sorted(routed):
            jobs_s = routed[sid]
            with TRACER.span("scheduler.shard.encode") as enc_span:
                enc_span.set_tag("shard", str(sid))
                st = self._state(sid)
                sub_nodes, sub_parts = self._sub_lists(
                    plan, partitions, nodes, sid
                )
                snapshot = st.inv.refresh(sub_nodes, sub_parts)
                if deductions:
                    name_idx_s = st.inv.name_idx
                    for _nm, (hint, dvec) in sorted(deductions.items()):
                        for h in hint:
                            spos = name_idx_s.get(h)
                            if spos is not None:
                                snapshot.free[spos] -= dvec
                demands_s = [demands[j] for j in jobs_s]
                prio_s = (
                    [priorities[j] for j in jobs_s]
                    if priorities is not None
                    else None
                )
                batch = st.rows.encode(
                    [demand_key(all_pods[j]) for j in jobs_s],
                    demands_s,
                    snapshot,
                    codes_token=st.inv.codes_token(),
                    priorities=prio_s,
                )
                enc_span.count("rows", int(batch.num_shards))
                enc_span.count("jobs", len(jobs_s))
                n_pend_local = sum(1 for j in jobs_s if j < n_pending)
                incumbent, shard_rows = self._pin_incumbents(
                    st, snapshot, batch, all_pods, jobs_s, n_pend_local
                )
            work.append(
                (sid, st, snapshot, batch, incumbent, shard_rows, jobs_s,
                 n_pend_local)
            )
        self.last_encode_ms = (time.perf_counter() - t0) * 1e3

        # ---- solve (fanned; results keyed by shard id) ----
        self.last_routes = {}
        results: dict[int, Placement] = {}

        def run_one(item):
            sid, st, snapshot, batch, incumbent = item[:5]
            t1 = time.perf_counter()
            with TRACER.span("scheduler.shard.solve") as span:
                span.set_tag("shard", str(sid))
                placement, engine = self._solve_shard(
                    st, snapshot, batch, incumbent, sid=sid
                )
                span.set_tag("engine", engine)
                span.count("shards", int(batch.num_shards))
                span.count("nodes", snapshot.num_nodes)
            _shard_solve_seconds.observe(time.perf_counter() - t1)
            _shard_route.inc(engine=engine)
            return sid, placement, engine

        workers = max(1, self.config.workers)
        if workers > 1 and len(work) > 1:
            parent = TRACER.current()
            pool = self._get_pool(workers)

            def run_traced(item):
                with with_current_span(parent):
                    return run_one(item)

            outs = list(pool.map(run_traced, work))
        else:
            outs = [run_one(item) for item in work]
        for sid, placement, engine in outs:
            results[sid] = placement
            self.last_routes[engine] = self.last_routes.get(engine, 0) + 1

        return self._merge(
            plan, free, work, results, demands, all_pods, n_pending, policy,
            nodes,
        )

    def _get_pool(self, workers: int):
        with self._pool_lock:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=workers, thread_name_prefix="sbt-shard"
                )
            return self._pool

    def close(self) -> None:
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    # ---- per-shard internals (mirror _solve_local / _solve) ----

    def _pin_incumbents(
        self, st, snapshot, batch, all_pods, jobs_s, n_pend_local
    ):
        """Streaming-incumbent pinning, per shard: release usage, pin
        rows to held nodes, drop shards whose hint vanished, +0.5
        tie-break — exactly the monolithic semantics."""
        name_idx = st.inv.name_idx
        incumbent = np.full(batch.num_shards, -1, np.int32)
        shard_rows: dict[int, list[int]] = {}
        for row in range(batch.num_shards):
            shard_rows.setdefault(int(batch.job_of[row]), []).append(row)
        for lj in range(n_pend_local, len(jobs_s)):
            pod = all_pods[jobs_s[lj]]
            hints = getattr(pod, "hint", None) or getattr(
                getattr(pod, "spec", None), "placement_hint", ()
            )
            for k, row in enumerate(shard_rows.get(lj, [])):
                node = name_idx.get(hints[k]) if k < len(hints) else None
                if node is not None:
                    incumbent[row] = node
                    snapshot.free[node] += batch.demand[row]
                else:
                    batch.partition_of[row] = PAD_PARTITION
                    batch.demand[row] = 0.0
        if n_pend_local < len(jobs_s):
            batch.priority[batch.job_of >= n_pend_local] += 0.5
        return incumbent, shard_rows

    def _remote_solve(self, sid, engine, policy, snapshot, batch, incumbent):
        """Fleet dispatch (ISSUE 17): ship this shard's columns to its
        owning replica's solver sidecar. None -> solve inline (no fleet
        attached, shard unkeyed, or the remembered-fallback path after a
        sidecar death — the tick always completes)."""
        remote = self.remote
        if remote is None or sid < 0:
            return None
        return remote.try_solve(sid, engine, policy, snapshot, batch, incumbent)

    def _solve_shard(self, st, snapshot, batch, incumbent, sid=-1):
        """Route ONE shard's solve; returns (placement, engine name).

        The remote engine names ("greedy-remote"/"native-remote") surface
        in ``last_routes`` and metrics only — placements are byte-parity
        with inline (fleet/columnar.py), so digests never see the split.
        """
        if self.backend == "greedy":
            placement = self._remote_solve(
                sid, "greedy", "", snapshot, batch, incumbent
            )
            if placement is not None:
                return placement, "greedy-remote"
            return (
                greedy_place(snapshot, batch, incumbent=incumbent),
                "greedy",
            )
        # promoted device path: a shard big enough to amortize the mesh
        # collectives rides the multi-device sweep whenever ≥2 devices
        # exist; with fewer it stays on the single-device auction below
        cells = batch.num_shards * snapshot.num_nodes
        if self.config.device_solve is not False:
            forced = self.config.device_solve is True
            if forced or cells >= self.config.sharded_threshold:
                placement = self._try_device_sharded(
                    snapshot, batch, incumbent, forced
                )
                if placement is not None:
                    return placement, "auction-sharded"
        from slurm_bridge_tpu_torch.solver.routing import (
            choose_path,
            gang_shard_fraction,
            incumbent_fraction,
            native_fit_policy,
        )

        if self.backend == "auto":
            from slurm_bridge_tpu_torch.parallel.backend import ensure_backend

            route = choose_path(
                batch.num_shards,
                snapshot.num_nodes,
                backend_name=ensure_backend(self.device),
                gang_fraction=gang_shard_fraction(batch.gang_id),
                inc_fraction=incumbent_fraction(incumbent),
            )
            if route == "native":
                from slurm_bridge_tpu_torch.solver.indexed_native import (
                    indexed_place_native,
                )

                policy = native_fit_policy(bool((incumbent >= 0).any()))
                placement = self._remote_solve(
                    sid, "native", policy, snapshot, batch, incumbent
                )
                if placement is not None:
                    return placement, "native-remote"
                return (
                    indexed_place_native(
                        snapshot,
                        batch,
                        incumbent=incumbent,
                        policy=policy,
                    ),
                    "native",
                )
        # single-device auction (explicit auction pin, or auto-device):
        # serialized — shards share one accelerator
        from slurm_bridge_tpu_torch.solver.session import DeviceSolver

        p_real = batch.num_shards
        if self.bucket:
            batch = pad_batch(batch, self.bucket)
            if batch.num_shards != p_real:
                incumbent = np.concatenate(
                    [incumbent, np.full(batch.num_shards - p_real, -1, np.int32)]
                )
        with self._device_lock:
            if st.solver is None:
                st.solver = DeviceSolver(
                    snapshot, self.auction_config, device=self.device
                )
            else:
                st.solver.update_snapshot(snapshot)
            placement = st.solver.solve(batch, incumbent=incumbent)
        if placement.node_of.shape[0] != p_real:
            placement = Placement(
                node_of=placement.node_of[:p_real],
                placed=placement.placed[:p_real],
                free_after=placement.free_after,
            )
        return placement, "auction"

    def _try_device_sharded(
        self, snapshot, batch, incumbent, forced: bool
    ) -> Placement | None:
        """The multi-device sweep, or None (→ the single-device auction)
        when the process solves on fewer than two devices. Nothing here
        turns a device failure into a CPU solve: it propagates."""
        from slurm_bridge_tpu_torch.parallel.backend import ensure_backend
        from slurm_bridge_tpu_torch.parallel.mesh import device_count

        if device_count(ensure_backend(self.device)) < 2:
            return None
        from slurm_bridge_tpu_torch.solver.sharded import sharded_place

        p_real = batch.num_shards
        inc = incumbent
        if self.bucket:
            batch = pad_batch(batch, self.bucket)
            if batch.num_shards != p_real:
                inc = np.concatenate(
                    [inc, np.full(batch.num_shards - p_real, -1, np.int32)]
                )
        with self._device_lock:
            placement = sharded_place(
                snapshot, batch, self.auction_config, incumbent=inc,
                device=self.device,
            )
        if placement.node_of.shape[0] != p_real:
            placement = Placement(
                node_of=placement.node_of[:p_real],
                placed=placement.placed[:p_real],
                free_after=placement.free_after,
            )
        return placement

    # ---- merge + reconcile ----

    def _merge(
        self, plan, free, work, results, demands, all_pods, n_pending,
        policy, nodes,
    ):
        with TRACER.span("scheduler.shard.merge") as merge_span:
            out = self._merge_traced(
                plan, free, work, results, demands, all_pods, n_pending,
                policy, nodes,
            )
            merge_span.count("jobs_placed", len(out[0]))
            merge_span.count("lost", len(out[1]))
            return out

    def _merge_traced(
        self, plan, free, work, results, demands, all_pods, n_pending,
        policy, nodes,
    ):
        by_job_names: dict[int, list[str]] = {}
        lost_jobs: list[int] = []
        residual = free.copy()
        #: integral-granularity correction for the ADMISSION window only
        #: (reconcile keeps the float residual byte-for-byte): this
        #: tick's pending binds re-subtracted at ceil — see the
        #: monolithic seam in bridge/scheduler.py
        win_adj = np.zeros_like(residual) if self._capture_residual else None
        failed_gangs: list[dict] = []
        names_of = plan.pos_name
        for item in work:
            (sid, st, snapshot, batch, incumbent, shard_rows, jobs_s,
             n_pend_local) = item
            placement = results[sid]
            node_idx = plan.shards[sid].node_idx
            residual[node_idx] = placement.free_after
            if win_adj is not None:
                pr = np.nonzero(
                    placement.placed & (batch.job_of < n_pend_local)
                )[0]
                if pr.size:
                    adj = np.ceil(batch.demand[pr]) - batch.demand[pr]
                    np.add.at(
                        win_adj, node_idx[placement.node_of[pr]], adj
                    )
            by_local = placement.by_job(batch)
            if policy is not None and policy.config.backfill:
                for row, node in policy.backfill(
                    snapshot, batch, placement, n_pend_local,
                    rank_of=lambda lj, js=jobs_s: policy.class_rank_of_job(js[lj]),
                ):
                    by_local.setdefault(int(batch.job_of[row]), []).append(node)
                    residual[int(node_idx[node])] -= batch.demand[row]
                    if win_adj is not None:
                        win_adj[int(node_idx[node])] += (
                            np.ceil(batch.demand[row]) - batch.demand[row]
                        )
            for lj, idxs in by_local.items():
                by_job_names[jobs_s[lj]] = [
                    snapshot.node_names[i] for i in idxs
                ]
            for lj in range(n_pend_local, len(jobs_s)):
                if any(
                    incumbent[r] >= 0 and placement.node_of[r] != incumbent[r]
                    for r in shard_rows.get(lj, [])
                ):
                    lost_jobs.append(jobs_s[lj])
            # fully-unplaced pending gangs → reconcile candidates
            if self.config.reconcile:
                for lj in range(n_pend_local):
                    rows = shard_rows.get(lj, [])
                    if len(rows) <= 1 or lj in by_local:
                        continue
                    if any(placement.placed[r] for r in rows):
                        continue  # partial remnants are dead this tick
                    r0 = rows[0]
                    j = jobs_s[lj]
                    failed_gangs.append({
                        "j": j,
                        "d": batch.demand[r0].copy(),
                        "need": len(rows),
                        "part": demands[j].partition,
                        "req": int(batch.req_features[r0]),
                        "rank": (
                            policy.class_rank_of_job(j)
                            if policy is not None
                            else 0
                        ),
                        "prio": float(batch.priority[r0]),
                    })
        lost_jobs.sort()

        self.last_reconcile_attempts = len(failed_gangs)
        self.last_reconcile_placed = 0
        #: global feature masks, shared by reconcile and the explain
        #: capture below — built at most once per tick, and ONLY when
        #: something actually needs them (spilled gangs here; unplaced
        #: jobs in the capture's own fallback)
        gfeats = (
            self._global_features(plan, work, nodes) if failed_gangs else None
        )
        #: gangs that reached the reconcile pass and STILL failed — the
        #: SHARD_SPILL population the attribution pass marks
        spilled: set[int] = set()
        if failed_gangs:
            # the cross-shard pass runs ONLY when some shard reported
            # spill — zero failed gangs means zero reconcile cost (and no
            # span: absence in the tree IS the attribution)
            with TRACER.span("scheduler.shard.reconcile") as rec_span:
                placed = reconcile_gangs(
                    failed_gangs,
                    residual,
                    gfeats,
                    plan.part_nodes,
                    limit=self.config.reconcile_limit,
                )
                rec_span.count("attempts", len(failed_gangs))
                rec_span.count("placed", len(placed))
            self.last_reconcile_placed = len(placed)
            spilled = {c["j"] for c in failed_gangs} - {j for j, _ in placed}
            if self._trail is not None and self._trail_job >= 0:
                tj = self._trail_job
                if any(c["j"] == tj for c in failed_gangs):
                    took = next((ns for j, ns in placed if j == tj), None)
                    self._trail.add(
                        "reconcile",
                        "cross-shard pass placed the gang on the merged "
                        "residual"
                        if took is not None
                        else "cross-shard pass attempted the gang against "
                        "the merged residual and could not place it",
                    )
            if win_adj is not None and placed:
                # reconcile debits `residual` at the float model (that
                # residual is reconcile's own byte-pinned contract);
                # the ADMISSION window needs the integral-granularity
                # correction for these placements too, or it would
                # overstate free capacity on exactly the nodes the
                # reconciled gangs are about to allocate
                d_of = {c["j"]: c["d"] for c in failed_gangs}
                for j, positions in placed:
                    dv = d_of[j]
                    adj = np.ceil(dv) - dv
                    for p in positions:
                        win_adj[p] += adj
            for j, positions in placed:
                by_job_names[j] = [names_of[p] for p in positions]
            _shard_reconcile.inc(len(placed), outcome="placed")
            _shard_reconcile.inc(
                len(failed_gangs) - len(placed), outcome="unplaced"
            )
        self.reconcile_attempts_total += self.last_reconcile_attempts
        self.reconcile_placed_total += self.last_reconcile_placed
        self._note_locality(plan, by_job_names, demands, n_pending)
        if self._capture_residual:
            self.last_window = (
                self._window_snapshot(plan, work, nodes, demands),
                residual - win_adj,
                plan,
            )
        if self._explain:
            # explainability capture (ISSUE 15): one record per unplaced
            # pending job, read straight from the per-shard batch rows —
            # the residual is the float-model merged free AFTER backfill
            # and reconcile (the window above keeps its own ceil-adjusted
            # copy, so sharing `residual` here is safe)
            jobs_x: list[explain_mod.UnplacedJob] = []
            for item in work:
                (sid, _st, _snap, batch, _inc, shard_rows, jobs_s,
                 n_pend_local) = item
                for lj in range(n_pend_local):
                    j = jobs_s[lj]
                    if j in by_job_names:
                        continue
                    rows = shard_rows.get(lj)
                    if not rows:
                        continue
                    r0 = rows[0]
                    jobs_x.append(
                        explain_mod.UnplacedJob(
                            j=j,
                            partition=demands[j].partition,
                            d=batch.demand[r0].copy(),
                            need=len(rows),
                            req=int(batch.req_features[r0]),
                            shard=sid,
                            spilled=j in spilled,
                        )
                    )
            if jobs_x:
                self.last_explain_inputs = explain_mod.ExplainInputs(
                    free=residual,
                    capacity=self._capacity_cols(nodes),
                    features=(
                        gfeats
                        if gfeats is not None
                        else self._global_features(plan, work, nodes)
                    ),
                    part_members=plan.part_nodes,
                    jobs=jobs_x,
                )
            # a fully-placed tick keeps last_explain_inputs None: no
            # capacity columns, no global feature scatter — zero
            # explain cost beyond the unplaced scan above
        return by_job_names, lost_jobs

    def _capacity_cols(self, nodes) -> np.ndarray:
        """[N, 3] total-capacity columns on the global node axis,
        memoized on the (identity-stable) node list the decode caches
        replay while the inventory is unchanged."""
        memo = self._explain_cap_memo
        if memo is not None and memo[0] is nodes:
            return memo[1]
        cap = np.asarray(
            [(nd.cpus, nd.memory_mb, nd.gpus) for nd in nodes], np.float32
        )
        self._explain_cap_memo = (nodes, cap)
        return cap

    def _window_snapshot(self, plan, work, nodes, demands):
        """A global-axis ClusterSnapshot for the admission window: the
        per-shard snapshots stitched back onto the plan's node order —
        shared feature-code table, so demand feature masks stay
        comparable, and a partitions-identity memo so the per-tick cost
        is the feature scatter plus one free-array handoff."""
        from slurm_bridge_tpu_torch.solver.snapshot import (
            ClusterSnapshot,
            node_partition_map,
        )

        parts_ref = self._sub_cache[1] if self._sub_cache else None
        memo = self._window_parts
        if memo is None or memo[0] is not parts_ref or memo[1] is not plan:
            # rebuild the partition coding off the CURRENT partitions
            # list (identity-keyed, like every other per-tick memo)
            partitions = parts_ref if parts_ref is not None else []
            partition_codes, node_part = node_partition_map(partitions)
            partition_of = np.fromiter(
                (node_part.get(nm, -1) for nm in plan.pos_name),
                np.int32,
                len(plan.pos_name),
            )
            memo = self._window_parts = (
                parts_ref, plan, partition_codes, partition_of,
            )
        _p, _pl, partition_codes, partition_of = memo
        return ClusterSnapshot(
            node_names=list(plan.pos_name),
            capacity=np.zeros((len(plan.pos_name), 3), np.float32),
            free=np.zeros((0, 3), np.float32),  # the window carries its own
            partition_of=partition_of,
            features=self._global_features(plan, work, nodes),
            partition_codes=partition_codes,
            feature_codes=self._feature_codes,
        )

    def _global_features(self, plan, work, nodes) -> np.ndarray:
        """Per-node uint32 feature masks on the global axis, assembled
        from the per-shard snapshots (one shared code table ⇒ masks are
        directly comparable). Shards NO job routed to this tick have no
        snapshot — their nodes fold masks straight from the shared code
        table, because leaving them 0 would make reconcile reject
        feature-requiring gangs on exactly the idle capacity the pass
        exists to reach."""
        feats = np.zeros(plan.node_shard.shape[0], np.uint32)
        covered: set[int] = set()
        for item in work:
            sid, _st, snapshot = item[0], item[1], item[2]
            feats[plan.shards[sid].node_idx] = snapshot.features
            covered.add(sid)
        codes = self._feature_codes
        if self._feat_memo_token != len(codes):
            # a grown code table re-resolves previously-unknown features
            self._feat_memo = {}
            self._feat_memo_token = len(codes)
        memo = self._feat_memo
        for shard in plan.shards:
            if shard.sid in covered:
                continue
            for pos in shard.node_idx.tolist():
                ft = nodes[pos].features
                m = memo.get(ft)
                if m is None:
                    m = 0
                    for f in ft:
                        bit = codes.get(f)
                        if bit is not None:
                            m |= 1 << bit
                    memo[ft] = m
                feats[pos] = np.uint32(m)
        return feats

    def _note_locality(self, plan, by_job_names, demands, n_pending) -> None:
        """Rank-locality accounting: for every placed pending gang, the
        fraction of its shards inside ONE island (1.0 = fully
        ICI-local). The scorecard reports the run mean."""
        for j, names in by_job_names.items():
            if j >= n_pending or len(names) <= 1:
                continue
            isl = [
                int(plan.node_island[plan.name_pos[n]])
                for n in names
                if n in plan.name_pos
            ]
            if not isl:
                continue
            counts = np.bincount(np.asarray([i for i in isl if i >= 0]))
            best = int(counts.max()) if counts.size else 0
            self.locality_sum += best / len(names)
            self.locality_count += 1

    # ---- observability rollups ----

    def stats(self) -> dict:
        """Deterministic run aggregates (harness determinism/quality)."""
        return {
            "shard_count": self._plan.num_shards if self._plan else 0,
            "shard_ticks": self.ticks_total,
            "reconcile_attempts": self.reconcile_attempts_total,
            "reconcile_placed": self.reconcile_placed_total,
            "gang_rank_locality_mean": (
                round(self.locality_sum / self.locality_count, 4)
                if self.locality_count
                else None
            ),
            "gangs_scored": self.locality_count,
        }
