"""Placement scheduler — binds pending sizecar pods to virtual nodes.

This is the rebuilt placement path (SURVEY.md §7): where the reference
leaves placement to the kube-scheduler (one decision per pod, partition
node-affinity pod.go:109-141) and then pays one `scontrol` exec per pod per
status tick, this scheduler takes ONE batched snapshot of the whole node
inventory per tick, lowers the entire pending queue into dense matrices,
and solves the assignment with the device auction, whose score/choose step
is the hand-written ``bid_argmax`` kernel on the card (or the greedy packer
behind ``backend="greedy"`` — the reference-parity path kept intact per
BASELINE.md's north star). The default ``backend="auto"`` routes each tick
by backend and problem size (solver/routing.py): solves below the device
dispatch floor — or any solve without an accelerator — run on the indexed
native packer instead of paying a device round-trip.

A placed job's pod is bound to its partition's virtual node; the exact
Slurm nodes the solver chose ride along as ``spec.placement_hint`` (the
agent may pass them to ``sbatch --nodelist``; Slurm remains the final
arbiter). Unplaceable pods stay Pending with reason ``Unschedulable`` and
are retried next tick.

With ``preemption=True`` the tick is a streaming re-solve (BASELINE
config #5 in the product path): already-submitted pods join the batch as
incumbents pinned to their hinted nodes, and one that loses priority-
ordered admission is preempted — its Slurm jobs cancelled, its binding
cleared, its submit generation bumped so the agent's dedupe ledger treats
the requeue as a fresh submission.
"""

from __future__ import annotations

import logging
import time
from typing import NamedTuple

import numpy as np

from slurm_bridge_tpu_torch.bridge.objects import (
    Pod,
    PodPhase,
    PodRole,
    VirtualNode,
    partition_node_name,
)
from slurm_bridge_tpu_torch.bridge.freeze import fast_replace, frozen_replace
from slurm_bridge_tpu_torch.bridge.store import NotFound, ObjectStore
from slurm_bridge_tpu_torch.core.types import JobDemand, NodeInfo, PartitionInfo
from slurm_bridge_tpu_torch.obs import explain as explain_mod
from slurm_bridge_tpu_torch.obs.events import EventRecorder, Reason
from slurm_bridge_tpu_torch.obs.metrics import REGISTRY
from slurm_bridge_tpu_torch.obs.metrics import Histogram
from slurm_bridge_tpu_torch.obs.tracing import TRACER
from slurm_bridge_tpu_torch.solver import AuctionConfig, auction, greedy_place
from slurm_bridge_tpu_torch.solver.encoder import EncodedInventory, JobRowCache
from slurm_bridge_tpu_torch.solver.session import DeviceSolver
from slurm_bridge_tpu_torch.solver.snapshot import (
    PAD_PARTITION,
    Placement,
    pad_batch,
)
from slurm_bridge_tpu_torch.wire import RpcError, ServiceClient, pb
from slurm_bridge_tpu_torch.wire.convert import (
    NodesDecodeCache,
    partition_from_proto,
)

log = logging.getLogger("sbt.scheduler")


class _RowPod(NamedTuple):
    """One schedulable pod captured for the tick — everything the
    encode/solve/bind pipeline needs, readable straight from columns so
    the 50k-pod cold scan materializes zero frozen views. The full
    frozen Pod rides along (``obj``) only on the OBJECT-backed store
    (pending and incumbents alike); columnar rows — including the
    incumbent scan since ISSUE 12 satellite c — carry ``obj=None``,
    and no incumbent path dereferences it."""

    name: str
    uid: str
    rv: int
    demand: object  # JobDemand | None (stored by reference — identity-stable)
    partition: str
    reason: str
    hint: tuple = ()
    obj: object = None
    #: pod labels (policy-bearing ticks only — tenant/class resolution);
    #: None on the policy-off hot path so the 50k cold scan pays nothing
    labels: object = None

_tick_seconds = REGISTRY.histogram(
    "sbt_scheduler_tick_seconds", "placement solve wall time per tick"
)
_encode_seconds = REGISTRY.histogram(
    "sbt_scheduler_encode_seconds",
    "inventory + queue lowering wall time per tick (cache-aware path)",
    buckets=Histogram.FAST_BUCKETS,
)
_store_seconds = REGISTRY.histogram(
    "sbt_scheduler_store_seconds",
    "store list + inventory RPC wall time per tick (the pre-solve phase)",
    buckets=Histogram.FAST_BUCKETS,
)
_solve_seconds = REGISTRY.histogram(
    "sbt_scheduler_solve_seconds", "placement solve wall time per tick"
)
_bind_seconds = REGISTRY.histogram(
    "sbt_scheduler_bind_seconds",
    "bind + preempt store-write wall time per tick",
    buckets=Histogram.FAST_BUCKETS,
)
_pods_placed = REGISTRY.counter("sbt_scheduler_pods_placed_total", "pods bound")
_pods_unplaced = REGISTRY.gauge(
    "sbt_scheduler_pods_unschedulable", "pods left pending after last tick"
)
_pods_preempted = REGISTRY.counter(
    "sbt_scheduler_pods_preempted_total", "pods preempted for higher priority work"
)
_route_total = REGISTRY.counter(
    "sbt_scheduler_route_total",
    "solve ticks per engine chosen by the routing rule",
)

#: Job ids whose preemption-cancel failed (agent unreachable); retried every
#: tick until they land — a dropped cancel would orphan the Slurm job while
#: the requeued pod resubmits, double-executing the workload.
PENDING_CANCEL_ANNOTATION = "sbt.kubecluster.org/pending-cancel"


class PlacementScheduler:
    def __init__(
        self,
        store: ObjectStore,
        client: ServiceClient,
        *,
        backend: str = "auto",
        auction_config: AuctionConfig | None = None,
        events: EventRecorder | None = None,
        preemption: bool = False,
        bucket: int = 1024,
        solver_endpoint: str = "",
        sharded: bool | None = None,
        sharded_threshold: int = 1 << 20,
        retry_cancel_timeout: float = 2.0,
        place_timeout: float = 120.0,
        inventory_ttl: float = 1.0,
        policy=None,
        shard=None,
        incremental: bool = False,
        admission=None,
        explain: bool = True,
        explain_target: str = "",
        device=None,
    ):
        #: where the device auction runs: None is the card (or
        #: SBT_BACKEND=cpu), "cpu" the host (parallel/backend.py)
        self.device = device
        if backend not in ("auto", "auction", "greedy"):
            raise ValueError(f"unknown scheduler backend {backend!r}")
        if backend == "auto":
            # validate-at-ingress: a malformed SBT_ROUTE_FLOOR_CELLS must
            # refuse startup, not fail every tick inside _solve
            from slurm_bridge_tpu_torch.solver.routing import floor_cells

            floor_cells()
        self.store = store
        self.client = client
        self.backend = backend
        #: whether the operator tuned this bridge's config explicitly —
        #: only then does it ride Place RPCs; otherwise the sidecar's own
        #: launch-time tuning must win (both directions of ADVICE r3)
        self._explicit_config = auction_config is not None
        self.auction_config = auction_config or AuctionConfig()
        self.events = events or EventRecorder()
        self.preemption = preemption
        #: placement policy engine (slurm_bridge_tpu_torch.policy) — priority
        #: classes, fair-share admission order, bounded preemption pool,
        #: backfill. None (the default) is the PR-8 tick byte-for-byte.
        self.policy = policy
        if policy is not None and solver_endpoint:
            # effective priorities ride the Place RPC since PR-10
            # (PlaceJob.priority_override), so admission order, the
            # preemption pool AND class dominance all survive the hop;
            # only the backfill second pass stays in-process-only
            log.info(
                "placement policy attached with a remote solver sidecar: "
                "effective priorities ride the Place RPC; the backfill "
                "pass does not apply on remote solves"
            )
        if policy is not None:
            # durable fair share (PR-10): a store restored from
            # snapshot+WAL carries the PolicyState singleton — hydrate
            # the ledger so accumulated service survives the restart
            policy.load_from_store(store)
        self.bucket = bucket
        #: the sharded-placement layer (slurm_bridge_tpu_torch.shard): plan the
        #: tick into partition/island shards, encode+solve each against
        #: per-shard caches, reconcile cross-shard gangs. None (the
        #: default) is the monolithic tick byte-for-byte — fixture-pinned
        #: like ``policy=None``.
        self.shard = None
        if shard is not None:
            from slurm_bridge_tpu_torch.shard import ShardExecutor

            self.shard = (
                shard
                if isinstance(shard, ShardExecutor)
                else ShardExecutor(
                    shard,
                    backend=backend,
                    auction_config=auction_config,
                    bucket=bucket,
                    device=device,
                )
            )
            if solver_endpoint:
                log.warning(
                    "sharded placement attached with a remote solver "
                    "sidecar: the sidecar owns encode+solve, so the "
                    "in-process shard fan-out is IGNORED on solver ticks"
                )
        #: sharded auto-select (VERDICT r2 #4): with ``sharded=None`` the
        #: multi-device shard_map sweep engages when a mesh exists AND the
        #: solve is big enough to amortize the collectives — tiny solves
        #: stay single-device (the P×N threshold mirrors auction.py's
        #: candidate-sampling cutover rule).
        self.sharded = sharded
        #: inventory reuse window: cluster_state costs two agent RPCs that
        #: each exec Slurm CLIs (~250 ms at 2k nodes, round-5 measurement)
        #: and was paid on EVERY tick. The reference's kubelet refreshes
        #: node status once a MINUTE (DefaultStatusUpdateInterval,
        #: virtual-kubelet options) — a ~1 s window is conservative, and
        #: the level-triggered loop self-corrects whatever staleness it
        #: admits. 0 disables.
        self.inventory_ttl = inventory_ttl
        self._inv_cache: tuple[float, list, list] | None = None
        #: content-keyed node decode memo: a steady tick's Nodes response
        #: is byte-identical to the last one, so the 10k-proto decode (and,
        #: via object identity, the inventory re-encode) is skipped
        self._nodes_decode = NodesDecodeCache()
        self.sharded_threshold = sharded_threshold
        #: per-RPC deadline for retry-context cancels (ADVICE r2: a dead
        #: agent must not stall the tick for the full deadline × backlog)
        self.retry_cancel_timeout = retry_cancel_timeout
        #: deadline for the remote Place RPC — a wedged sidecar must stall
        #: a tick at most this long, never wedge the scheduler thread
        self.place_timeout = place_timeout
        self._solver: DeviceSolver | None = None
        #: cross-tick encode caches (solver/encoder.py): the inventory
        #: snapshot survives the inventory_ttl window untouched and takes
        #: row deltas otherwise; pending pods' encoded rows carry forward
        #: keyed by (uid, resource_version)
        self._encoded = EncodedInventory()
        self._job_rows = JobRowCache()
        #: out-of-process PlacementSolver sidecar (SURVEY §7 item 4): when
        #: set, solves go over gRPC instead of in-process JAX
        self._remote: ServiceClient | None = None
        if solver_endpoint:
            from slurm_bridge_tpu_torch.wire.rpc import dial

            # retry=None: the scheduler thread must never sleep in
            # backoff — place_timeout bounds exactly ONE attempt and the
            # tick-skip fallback owns failure handling; retries would
            # stretch a down-sidecar tick by the whole backoff ladder
            self._remote = ServiceClient(
                dial(solver_endpoint), "PlacementSolver", retry=None
            )
        # cancels whose pod vanished before the failure could be annotated;
        # retried alongside the annotated ones
        self._orphan_cancels: set[int] = set()
        #: pods currently carrying a pending-cancel annotation, maintained
        #: from the store's per-kind dirty-set — the retry pass no longer
        #: scans all 50k pods per tick to find the (usually zero) carriers
        self._pending_cancel_pods: set[str] = set()
        self._cancel_scan_rv = 0
        #: demand-identity encode keys (PR-6): (uid, generation) where the
        #: generation bumps only when the pod's demand OBJECT changes —
        #: resource_version moves from unschedulable marks / binds no
        #: longer evict the encoded row. Entries hold the demand so its
        #: id cannot be reused while the key is live.
        self._demand_keys: dict[str, tuple[object, tuple[str, int]]] = {}
        self._demand_gen = 0
        #: which engine the last local solve ran on ("greedy", "native",
        #: "auction", "auction-sharded") — observability for the routing
        #: decision (VERDICT r3 #5); tests assert on it
        self.last_route: str = ""
        #: per-phase wall ms of the last tick (store/encode/solve/bind) —
        #: the breakdown the sim harness and the full-tick benchmark read;
        #: the histograms above carry the same numbers for Prometheus
        self.last_phase_ms: dict[str, float] = {}
        #: host syncs of the last tick's local solve (``host_syncs`` on
        #: its ``scheduler.solve`` span; ``solver.auction.note_sync``)
        self.last_host_syncs = 0
        #: event-driven incremental tick (PR-11). Off (the default) is the
        #: PR-10 tick byte-for-byte. On: the pending scan re-walks the ""
        #: index bucket only when the store's Pod dirty-set moved, the
        #: inventory fetch rides the agent's nodes-state cursor (same RPC
        #: count, O(changes) decode), and a tick whose solve inputs —
        #: inventory, demand keys, priorities, incumbent pins — are
        #: identical to the previous tick's reuses that tick's assignment
        #: outright (the solver is deterministic, so the reused result IS
        #: what a fresh solve would return — digest-provably). Bind /
        #: unschedulable marking always re-runs: it is already diff-only,
        #: and its events are part of the determinism contract.
        self.incremental = incremental
        #: pending-scan dirty cursor + cached row set (incremental mode)
        self._pending_rv = 0
        self._pending_cache: list[_RowPod] | None = None
        #: cluster_state reuse: (partition resp refs, partitions, cached
        #: NodesRequest) — valid while every Partition response is the
        #: identical proto object (the agent replays them unchanged)
        self._cs_memo: tuple | None = None
        self._nodes_cursor = 0
        self._nodes_cache: list | None = None
        #: last tick's solve memo: (nodes ref, partitions ref, keys,
        #: priorities, incumbent signature) → (by_job_names, lost_jobs)
        self._solve_memo: tuple | None = None
        #: solver-invocation accounting the steady-state gate reads
        self.solves_total = 0
        self.solve_reuses_total = 0
        #: streaming admission (ISSUE 12): the always-on fast path that
        #: binds interactive-class arrivals against the residual
        #: free_after view between batch ticks. None (the default) is
        #: the PR-11 tick byte-for-byte — fixture-pinned like policy=None
        #: and shard=None. With a remote solver sidecar there is no
        #: in-process residual to window, so the fast path stays dormant
        #: (every arrival falls through to the batch tick).
        self.admission = None
        if admission is not None:
            from slurm_bridge_tpu_torch.admission import FastPathAdmitter

            self.admission = (
                admission
                if isinstance(admission, FastPathAdmitter)
                else FastPathAdmitter(admission, policy=policy)
            )
            if solver_endpoint:
                log.warning(
                    "streaming admission attached with a remote solver "
                    "sidecar: the residual view cannot be rebuilt from a "
                    "remote solve, so the fast path will never bind"
                )
        #: (snapshot, post-backfill residual free) captured by the last
        #: in-process solve — what the admission window re-bases on
        self._adm_capture: tuple | None = None
        #: versioned unschedulable-backlog mark (ISSUE 12 satellite b,
        #: incremental mode only): PLACEMENT_FAILED events for an
        #: unchanged backlog are emitted once per backlog GENERATION — a
        #: generation being one fresh solve; warm-start (memo) ticks
        #: re-solve nothing and re-emit nothing. name → reason emitted
        #: in the current generation.
        self._unsched_emitted: dict[str, str] = {}
        #: ready-partition set of the last bind phase — the second half
        #: of the steady-bind skip: a warm-start tick whose ready set is
        #: unchanged provably reproduces the previous bind phase (same
        #: assignment, same marks, zero writes, generation already
        #: emitted), so the O(backlog) mark walk is skipped outright
        self._last_ready: set | None = None
        #: incumbent scan cache (ISSUE 12 satellite c): dirty-set cursor
        #: + cached row set, mirroring the pending-scan pair above
        self._incumbent_rv = 0
        self._incumbent_cache: list[_RowPod] | None = None
        #: placement explainability (ISSUE 15): per-job reason-code
        #: attribution from the solve's own artifacts. Off = the
        #: pre-ISSUE-15 generic reason strings byte-for-byte; on (the
        #: default) is digest-byte-identical by construction — explain
        #: only OBSERVES the tick (the bench-smoke overhead gate pins
        #: both facts, mirroring the trace/WAL gates).
        self.explain = explain
        #: one job's decision trail (``--explain <job>`` on the sim CLI)
        self.explain_trail = (
            explain_mod.ExplainTrail(explain_target) if explain_target else None
        )
        #: the last fresh solve's attribution inputs (residual free,
        #: capacity/feature columns, unplaced-job records) — retained
        #: across warm-start memo ticks, whose backlog is provably the
        #: generation's (same inputs ⇒ same reasons)
        self._explain_ctx: explain_mod.ExplainInputs | None = None
        #: (ctx identity, by_job_names identity) → codes memo: a memo
        #: tick re-marks the identical backlog, so attribution is pure
        #: replay and is not recomputed
        self._explain_memo: tuple | None = None
        #: per-partition member-position memo, keyed on the snapshot
        self._pm_memo: tuple | None = None
        #: the last solve tick's pressure ledger (reason × partition ×
        #: class × tenant + per-shard bottleneck) — the harness folds it
        #: into the flight record and quality scorecard; None on idle
        #: ticks and with explain off
        self.last_explain_ledger: dict | None = None
        #: the last BUILT ledger — replayed verbatim on steady-skip
        #: ticks, whose backlog is provably the generation's
        self._ledger_replay: dict | None = None

    # ---- inventory ----

    def cluster_state(self) -> tuple[list[PartitionInfo], list[NodeInfo]]:
        """One batched inventory query: every partition, every node, in two
        RPC round-trips — not one exec per pod (SURVEY.md §3.2). Reused
        within ``inventory_ttl`` so back-to-back ticks don't re-exec the
        Slurm CLIs."""
        if self._inv_cache is not None and self.inventory_ttl > 0:
            ts, parts, nodes = self._inv_cache
            if time.monotonic() - ts < self.inventory_ttl:
                return parts, nodes
        names = list(self.client.Partitions(pb.PartitionsRequest()).partitions)
        part_resps = [
            self.client.Partition(pb.PartitionRequest(partition=n))
            for n in names
        ]
        if self.incremental:
            partitions, nodes = self._cluster_state_incremental(part_resps)
            if nodes is None:
                # degenerate serve-once empty view (see below): must NOT
                # enter the TTL cache — a cached zero-node inventory
                # would mark the whole backlog unschedulable for the
                # window without even the retry RPC that heals it
                return partitions, []
        else:
            partitions = [partition_from_proto(r) for r in part_resps]
            node_names = self._merge_node_names(partitions)
            nodes = self._nodes_decode.decode(
                self.client.Nodes(pb.NodesRequest(names=node_names))
            )
        self._inv_cache = (time.monotonic(), partitions, nodes)
        return partitions, nodes

    @staticmethod
    def _merge_node_names(partitions) -> list[str]:
        seen: set[str] = set()
        node_names: list[str] = []
        for p in partitions:
            for n in p.nodes:
                if n not in seen:
                    seen.add(n)
                    node_names.append(n)
        return node_names

    def _cluster_state_incremental(self, part_resps):
        """The cursor-bearing inventory fetch (PR-11): identical RPC
        sequence to the full path — Partitions + one Partition each + one
        Nodes — but when every Partition response is the identical proto
        object the agent served last tick (its membership cache), the
        decoded partitions list, the merged name list and the Nodes
        request are all reused, and the Nodes call carries the
        nodes-state cursor so an unchanged inventory answers with zero
        rows and the previously-decoded (identity-stable) node list is
        replayed — which is exactly what lets EncodedInventory's identity
        hit and the solve memo fire downstream."""
        memo = self._cs_memo
        if (
            memo is not None
            and len(memo[0]) == len(part_resps)
            and all(a is b for a, b in zip(memo[0], part_resps))
        ):
            partitions, req = memo[1], memo[2]
        else:
            partitions = [partition_from_proto(r) for r in part_resps]
            req = pb.NodesRequest(names=self._merge_node_names(partitions))
            self._cs_memo = (tuple(part_resps), partitions, req)
            self._nodes_cursor = 0
            self._nodes_cache = None
        req.since_version = (
            self._nodes_cursor if self._nodes_cache is not None else 0
        )
        resp = self.client.Nodes(req)
        if resp.unchanged:
            if self._nodes_cache is not None:
                return partitions, self._nodes_cache
            # degenerate (a frozen stale_snapshot window replaying an
            # "unchanged" answer across a scheduler rebuild): None =
            # serve an empty view once but cache/advance NOTHING — not
            # the cursor, not the TTL slot — so the next tick retries
            # at since=0 and heals on the first real answer
            return partitions, None
        nodes = self._nodes_decode.decode(resp)
        self._nodes_cache = nodes
        self._nodes_cursor = int(resp.version)
        return partitions, nodes

    # ---- the solve tick ----

    def pending_pods(self) -> list[Pod]:
        # the ``(kind, node_name)`` index: unbound pods all live in the
        # "" bucket, so the pending scan never touches bound pods at all
        return [
            p
            for p in self.store.list_by_node(Pod.KIND, "")
            if p.spec.role == PodRole.SIZECAR
            and not p.meta.deleted
            and p.status.phase == PodPhase.PENDING
        ]

    def _pending_set(self) -> list[_RowPod]:
        """The tick's schedulable set as row records. Columnar stores
        feed it straight from the "" node-index bucket's columns (no
        frozen views); object stores wrap :meth:`pending_pods`.

        Incremental mode (PR-11): the scan is driven from the store's
        Pod dirty-set — when no pod has been written since the last
        scan, the previous tick's row set is still exact (same rows,
        same rvs) and is returned as-is; any write anywhere rebuilds.
        """
        if self.incremental:
            rv, changed, deleted = self.store.changes_since(
                Pod.KIND, self._pending_rv
            )
            if (
                not changed
                and not deleted
                and self._pending_cache is not None
            ):
                return self._pending_cache
            self._pending_rv = rv
            self._pending_cache = self._pending_scan()
            return self._pending_cache
        return self._pending_scan()

    def _pending_scan(self) -> list[_RowPod]:
        table = self.store.table(Pod.KIND)
        want_labels = self.policy is not None
        if table is None:
            return [
                _RowPod(
                    p.name, p.meta.uid, p.meta.resource_version,
                    p.spec.demand, p.spec.partition, p.status.reason,
                    p.spec.placement_hint, p,
                    p.meta.labels if want_labels else None,
                )
                for p in self.pending_pods()
            ]
        from slurm_bridge_tpu_torch.bridge.columns import PHASE_CODE
        from slurm_bridge_tpu_torch.bridge.objects import PodPhase as _PP

        ph_pending = PHASE_CODE[_PP.PENDING]
        c = table.cols
        with self.store.locked():
            # names→rows under the same lock hold as the column reads —
            # a concurrent delete+create recycles row indices
            names, rows = self.store.rows_by_node(Pod.KIND, "")
            if not names:
                return []
            keep = (
                (c.role[rows] == PodRole.SIZECAR)
                & ~c.deleted[rows]
                & (c.phase[rows] == ph_pending)
            )
            sel = np.nonzero(keep)[0]
            rws = rows[sel]
            # labels only on policy-bearing ticks: the column gather is
            # cheap but pure waste on the 50k policy-off cold scan
            lab = (
                c.labels[rws].tolist()
                if want_labels
                else (None,) * int(sel.size)
            )
            return [
                _RowPod(names[i], u, rv, d, p, r, hh, None, ll)
                for i, u, rv, d, p, r, hh, ll in zip(
                    sel.tolist(),
                    c.uid[rws].tolist(),
                    c.rv[rws].tolist(),
                    c.demand[rws].tolist(),
                    c.partition[rws].tolist(),
                    c.reason[rws].tolist(),
                    c.hint[rws].tolist(),
                    lab,
                )
            ]

    def _demand_key(self, rp) -> tuple[str, int]:
        """The encode-cache key for a pod: (uid, demand generation). The
        generation moves only when the demand object itself is replaced,
        so rv-only writes (unschedulable marks, binds) keep the encoded
        row warm across ticks. Accepts a :class:`_RowPod` or a full Pod
        (direct ``_solve_local`` callers)."""
        if isinstance(rp, _RowPod):
            uid, demand = rp.uid, rp.demand
        else:
            uid, demand = rp.meta.uid, rp.spec.demand
        ent = self._demand_keys.get(uid)
        if ent is None or ent[0] is not demand:
            self._demand_gen += 1
            ent = (demand, (uid, self._demand_gen))
            self._demand_keys[uid] = ent
        return ent[1]

    def _prune_demand_keys(self, live: list) -> None:
        if len(self._demand_keys) > 2 * len(live) + 1024:
            keep = {
                rp.uid if isinstance(rp, _RowPod) else rp.meta.uid
                for rp in live
            }
            self._demand_keys = {
                u: e for u, e in self._demand_keys.items() if u in keep
            }

    def incumbent_pods(self) -> list[Pod]:
        """Bound sizecar pods with live Slurm jobs — the preemption pool."""
        return [
            p
            for p in self.store.list(Pod.KIND)
            if p.spec.role == PodRole.SIZECAR
            and p.spec.node_name
            and p.spec.placement_hint
            and p.status.job_ids
            and not p.meta.deleted
            and p.status.phase in (PodPhase.PENDING, PodPhase.RUNNING)
        ]

    def _incumbent_rows(self) -> list[_RowPod]:
        """The preemption pool as row records (ISSUE 12 satellite c).

        Columnar stores answer it straight from the node/phase columns —
        one vectorized mask over the table instead of a full store list
        materializing 50k frozen views per tick — and incremental mode
        additionally caches the row set behind the store's Pod dirty-set
        cursor, so a steady preemption-enabled tick re-walks nothing.
        Content and order (name-sorted, like ``store.list``) are
        identical to :meth:`incumbent_pods` by construction.
        """
        if self.incremental:
            rv, changed, deleted = self.store.changes_since(
                Pod.KIND, self._incumbent_rv
            )
            if (
                not changed
                and not deleted
                and self._incumbent_cache is not None
            ):
                return self._incumbent_cache
            self._incumbent_rv = rv
            self._incumbent_cache = self._incumbent_scan()
            return self._incumbent_cache
        return self._incumbent_scan()

    def _incumbent_scan(self) -> list[_RowPod]:
        table = self.store.table(Pod.KIND)
        want_labels = self.policy is not None
        if table is None:
            return [
                _RowPod(
                    p.name, p.meta.uid, p.meta.resource_version,
                    p.spec.demand, p.spec.partition, p.status.reason,
                    p.spec.placement_hint, p,
                    p.meta.labels if want_labels else None,
                )
                for p in self.incumbent_pods()
            ]
        from slurm_bridge_tpu_torch.bridge.columns import PHASE_CODE
        from slurm_bridge_tpu_torch.bridge.objects import PodPhase as _PP

        ph_pending = PHASE_CODE[_PP.PENDING]
        ph_running = PHASE_CODE[_PP.RUNNING]
        c = table.cols
        with self.store.locked():
            names = sorted(table.row_of)  # store.list order
            if not names:
                return []
            rows = np.fromiter(
                (table.row_of[n] for n in names), np.int64, len(names)
            )
            keep = (
                (c.role[rows] == PodRole.SIZECAR)
                & ~c.deleted[rows]
                & (c.node[rows] != "")
                & (c.njobs[rows] > 0)
                & (
                    (c.phase[rows] == ph_pending)
                    | (c.phase[rows] == ph_running)
                )
            )
            sel = np.nonzero(keep)[0]
            rws = rows[sel]
            lab = (
                c.labels[rws].tolist()
                if want_labels
                else (None,) * int(sel.size)
            )
            return [
                _RowPod(names[i], u, rv, d, p, r, hh, None, ll)
                for i, u, rv, d, p, r, hh, ll in zip(
                    sel.tolist(),
                    c.uid[rws].tolist(),
                    c.rv[rws].tolist(),
                    c.demand[rws].tolist(),
                    c.partition[rws].tolist(),
                    c.reason[rws].tolist(),
                    c.hint[rws].tolist(),
                    lab,
                )
                if hh  # bound-with-hints: the incumbent contract
            ]

    def tick(self) -> int:
        """Solve one placement round; returns the number of pods bound.

        One root span per tick with one child span per phase — the span
        durations ARE ``last_phase_ms`` now (the ad-hoc dict is derived
        from them), and each phase span carries its counts (pods scanned,
        rows encoded, commits written) so the flight recorder attributes
        the tick without a second timing system.
        """
        with TRACER.span("scheduler.tick") as tick_span:
            placed = self._tick(tick_span)
            tick_span.count("placed", placed)
            return placed

    def _tick(self, tick_span) -> int:
        self.last_phase_ms = {"store": 0.0, "encode": 0.0, "solve": 0.0, "bind": 0.0}
        self.last_host_syncs = 0
        self.last_explain_ledger = None
        with TRACER.span("scheduler.store") as store_span:
            self._retry_pending_cancels()
            if self.admission is not None:
                self._prune_deductions()
            with TRACER.span("scheduler.store.pending"):
                pods = self._pending_set()
            store_span.count("pods_pending", len(pods))
            if pods:
                # every engine honours incumbent pinning since round 5
                # (the oracle and indexed packer reserve-first, the
                # auction by candidate substitution), so preemption is
                # engine-independent
                incumbents = (
                    self._incumbent_rows() if self.preemption else []
                )
                store_span.count("incumbents", len(incumbents))
                t0 = time.perf_counter()
                with TRACER.span("scheduler.store.inventory"):
                    partitions, nodes = self.cluster_state()
                store_span.count("nodes", len(nodes))
        store_s = store_span.duration
        self.last_phase_ms["store"] = store_s * 1e3
        if not pods:
            # nothing pending ⇒ nothing can displace anyone; keep the idle
            # tick free (no inventory RPCs, no solve). The admission
            # window was NOT re-based this tick, so the next provider
            # inventory report may maintain it (note_inventory) — the
            # idle-cluster completion pickup of ROADMAP follow-up (c).
            if self.admission is not None:
                self.admission.allow_inventory_rebase()
            _pods_unplaced.set(0)
            return 0
        _store_seconds.observe(store_s)
        # the solve's inputs: the policy pass, the demand list (and,
        # below, the warm-start key) — the first part of "other"
        with TRACER.span("scheduler.prepare"):
            priorities = None
            if self.policy is not None:
                # the policy pass: class/tenant resolution, fair-share
                # admission order, bounded preemption pool, per-job effective
                # priorities the solver admits by (see policy/engine.py)
                self.policy.begin_tick(nodes)
                pods, incumbents, priorities = self.policy.prepare(
                    pods, incumbents
                )
            trail = self.explain_trail
            t_idx = -1
            if trail is not None:
                for _j, _p in enumerate(pods):
                    if trail.matches(_p.name):
                        t_idx = _j
                        msg = f"pending in partition {_p.partition!r}"
                        if priorities is not None:
                            msg += (
                                f", fair-share slot {_j} of {len(pods)}, "
                                f"effective priority {priorities[_j]:g}"
                            )
                        trail.add("queue", msg)
                        break
            all_pods = pods + incumbents
            demands: list[JobDemand] = []
            for pod in all_pods:
                d = pod.demand or JobDemand(partition=pod.partition)
                demands.append(d)
            n_pending = len(pods)
        #: whether this tick ran (or will run) a FRESH solve — the
        #: backlog-generation boundary for the versioned unschedulable
        #: mark (satellite b): a warm-start tick re-solves nothing, so
        #: its unchanged backlog re-emits nothing
        fresh_solve = True
        if self._remote is not None:
            # the sidecar owns encode+solve; report the RPC as the solve
            with TRACER.span("scheduler.solve", engine="remote") as solve_span:
                solved = self._solve_remote(
                    partitions, nodes, demands, all_pods, n_pending,
                    priorities=priorities,
                )
            remote_solve_s = solve_span.duration
            self.last_phase_ms["solve"] = remote_solve_s * 1e3
            _solve_seconds.observe(remote_solve_s)
            if solved is None:
                # sidecar unreachable: genuinely skip the tick — binding
                # nothing is right, but marking pods Unschedulable (a
                # capacity verdict) or preempting would be a false
                # diagnosis; the level-triggered loop retries next tick
                return 0
            by_job_names, lost_jobs = solved
        else:
            memo_key = None
            reused = None
            if self.incremental:
                # warm start (PR-11): identical solve inputs — the same
                # identity-stable inventory lists, the same demand keys,
                # priorities and incumbent pins — make a fresh solve a
                # pure replay (every engine is deterministic), so the
                # previous tick's assignment is reused outright and the
                # solver is not invoked at all. Bind/mark re-runs below
                # either way: it is diff-only, and its events are part
                # of the determinism contract.
                with TRACER.span("scheduler.prepare"):
                    memo_key = self._solve_key(all_pods, priorities, n_pending)
                m = self._solve_memo
                if (
                    m is not None
                    and m[0] is nodes
                    and m[1] is partitions
                    and m[2] == memo_key
                ):
                    reused = m[3]
            if reused is not None:
                with TRACER.span("scheduler.solve", engine="memo") as ssp:
                    ssp.count("reused", 1)
                self.last_phase_ms["solve"] = ssp.duration * 1e3
                _solve_seconds.observe(ssp.duration)
                self.last_route = "memo"
                _route_total.inc(engine="memo")
                self.solve_reuses_total += 1
                fresh_solve = False
                by_job_names, lost_jobs = reused
            elif self.shard is not None:
                by_job_names, lost_jobs = self._solve_sharded(
                    partitions, nodes, demands, all_pods, n_pending,
                    priorities=priorities, trail=trail, trail_job=t_idx,
                )
            else:
                by_job_names, lost_jobs = self._solve_local(
                    partitions, nodes, demands, all_pods, n_pending,
                    priorities=priorities,
                )
            if memo_key is not None and reused is None:
                self._solve_memo = (
                    nodes, partitions, memo_key, (by_job_names, lost_jobs)
                )
        if trail is not None and t_idx >= 0:
            names_t = by_job_names.get(t_idx)
            if names_t:
                trail.add("solve", f"assigned nodes {','.join(names_t)}")
            else:
                trail.add(
                    "solve",
                    "left unplaced by the solve (and any backfill/"
                    "reconcile second pass)",
                )
        with TRACER.span("scheduler.bind") as bind_span:
            ready_nodes = {
                vn.partition
                for vn in self.store.list(VirtualNode.KIND)
                if vn.ready and not vn.meta.deleted
            }
            if (
                self.incremental
                and not fresh_solve
                and not lost_jobs
                and ready_nodes == self._last_ready
            ):
                # the steady-bind skip (satellite b, the other half of
                # the versioned mark): a warm-start tick whose ready set
                # is unchanged reproduces the previous bind phase
                # EXACTLY — the reused assignment bound nothing (a bind
                # last tick would have changed the pending set and
                # broken the memo), the marks rewrite nothing (reasons
                # already written by this generation's fresh solve), and
                # the versioned mark already emitted them — so the
                # O(backlog) mark walk is pure replay and is skipped.
                bind_span.count("steady_skip", 1)
                bind_span.count("binds", 0)
                bind_span.count("unschedulable", 0)
                # no window re-base this tick either: let the provider
                # inventory probe maintain it (note_inventory)
                if self.admission is not None:
                    self.admission.allow_inventory_rebase()
                # the skipped mark walk's ledger is a pure replay of the
                # generation's (same backlog ⇒ same reasons), so the
                # pressure accounting stays tick-for-tick identical to
                # the full tick's — quality.wait_reasons is part of the
                # incremental≡full contract the quality gate enforces
                if self.explain:
                    self.last_explain_ledger = self._ledger_replay
                bind_s = bind_span.duration
                self.last_phase_ms["bind"] = bind_s * 1e3
                _bind_seconds.observe(bind_s)
                _tick_seconds.observe(time.perf_counter() - t0)
                _pods_unplaced.set(len(pods))
                return 0
            self._last_ready = ready_nodes
            #: per-job primary reason codes, attributed VECTORIZED from
            #: the solve's own artifacts (ISSUE 15) — {} with explain
            #: off or on attribution-less ticks (remote solver)
            codes: dict[int, str] = {}
            if self.explain:
                codes = self._explain_codes(
                    pods, demands, by_job_names, n_pending
                )
            ledger_rows: list | None = [] if self.explain else None
            binds: list[tuple[Pod, str, tuple[str, ...]]] = []
            unschedulable: list[tuple[Pod, str]] = []
            admitted_idx: list[int] = []
            no_vnode_reason: dict[str, str] = {}  # interned per partition
            for j, pod in enumerate(pods):
                names = by_job_names.get(j)
                partition = demands[j].partition
                if names and partition in ready_nodes:
                    binds.append((pod, partition_node_name(partition), tuple(names)))
                    admitted_idx.append(j)
                    if trail is not None and j == t_idx:
                        trail.add(
                            "bind",
                            f"bound to {partition_node_name(partition)} "
                            f"(nodes {','.join(names)})",
                        )
                    continue
                if partition in ready_nodes:
                    if self.explain:
                        code = codes.get(j, explain_mod.UNKNOWN)
                        reason = explain_mod.reason_string(code)
                    else:
                        code = ""
                        reason = "Unschedulable: insufficient capacity"
                else:
                    if self.explain:
                        code = explain_mod.NO_READY_VNODE
                        reason = explain_mod.reason_string(code, partition)
                    else:
                        code = ""
                        reason = no_vnode_reason.get(partition)
                        if reason is None:
                            reason = no_vnode_reason[partition] = (
                                "Unschedulable: no ready virtual node for "
                                f"partition {partition!r}"
                            )
                unschedulable.append((pod, reason))
                if ledger_rows is not None:
                    ledger_rows.append((j, code, partition, pod.labels))
                if trail is not None and j == t_idx:
                    trail.add("verdict", reason)
            if ledger_rows is not None:
                # the per-tick pressure ledger (sink 2): reason ×
                # partition × class × tenant counts + per-shard
                # bottleneck — its per-reason counts sum to the
                # unplaced count by construction (one row per mark)
                self.last_explain_ledger = self._build_pressure_ledger(
                    ledger_rows
                )
                self._ledger_replay = self.last_explain_ledger
            if self.policy is not None:
                # fair-share charge for what actually reached the bind
                # list — a solver assignment whose partition has no
                # ready virtual node grants no service, and charging it
                # would starve that tenant once the node comes up
                self.policy.note_admitted(admitted_idx)
                # ...and the ledger rides the WAL (PR-10): a no-charge
                # tick writes nothing
                self.policy.save_to_store(self.store)
            # versioned unschedulable mark (satellite b): a fresh solve
            # opens a new backlog generation — everything re-emits and
            # the emitted ledger resets; a warm-start tick's backlog is
            # provably IDENTICAL to the previous tick's (same inputs ⇒
            # same assignment ⇒ same leftovers), so its events carry no
            # information and are skipped. Incremental mode only: the
            # full tick keeps the per-tick level-triggered emission.
            if self.incremental and fresh_solve:
                self._unsched_emitted = {}
            self._mark_unschedulable_batch(
                unschedulable, emit_all=not self.incremental
            )
            placed = self._bind_batch(binds)
            preempted = 0
            for j in lost_jobs:
                if self._preempt(all_pods[j]):
                    preempted += 1
                    if trail is not None and trail.matches(all_pods[j].name):
                        trail.add(
                            "preempt", "displaced by higher-priority work"
                        )
            if self.admission is not None:
                self._rebase_admission_window(
                    demands, by_job_names, n_pending
                )
            bind_span.count("binds", placed)
            bind_span.count("unschedulable", len(unschedulable))
            bind_span.count("preempted", preempted)
        if placed or preempted:
            # a state-changing tick invalidates the inventory reuse window:
            # the next tick must see the allocations it just caused. The
            # cache's win is the NO-progress retry loop — an unschedulable
            # backlog re-ticked 5×/s was re-execing the Slurm CLIs each time
            self._inv_cache = None
        bind_s = bind_span.duration
        self.last_phase_ms["bind"] = bind_s * 1e3
        _bind_seconds.observe(bind_s)
        _tick_seconds.observe(time.perf_counter() - t0)
        _pods_placed.inc(placed)
        _pods_preempted.inc(preempted)
        _pods_unplaced.set(len(pods) - placed)
        return placed

    def _solve_key(self, all_pods, priorities, n_pending) -> tuple:
        """The solve-input identity for the warm-start memo: demand keys
        (uid + demand generation — rv-only writes don't move them),
        effective priorities, and incumbent pins. The inventory half of
        the identity is the (nodes, partitions) list refs themselves,
        compared by ``is`` against the memo (the decode caches replay
        identical lists exactly when nothing changed on the agent)."""
        inc_sig = tuple(
            (
                p.uid if isinstance(p, _RowPod) else p.meta.uid,
                tuple(
                    p.hint
                    if isinstance(p, _RowPod)
                    else p.spec.placement_hint
                ),
            )
            for p in all_pods[n_pending:]
        )
        return (
            tuple(self._demand_key(p) for p in all_pods),
            None if priorities is None else tuple(priorities),
            inc_sig,
            n_pending,
            # in-flight fast-path binds are subtracted from the solve's
            # free view, so a dropped (or added) deduction is a solve-
            # input change even when nothing else moved
            self.admission.deduction_signature()
            if self.admission is not None
            else (),
        )

    def _solve_local(
        self, partitions, nodes, demands, all_pods, n_pending,
        priorities=None,
    ) -> tuple[dict[int, list[str]], list[int]]:
        """In-process solve: encode, pin incumbents, run the kernel.

        ``priorities`` (policy ticks) overrides the per-job admission
        priorities without touching the cached encode rows — the row
        cache stays keyed on demand identity, the override is applied at
        batch assembly (solver/encoder.py).

        Returns (job index → assigned node names, incumbent job indices
        that lost their nodes and must be preempted).
        """
        self.solves_total += 1
        with TRACER.span("scheduler.encode") as enc_span:
            snapshot = self._encoded.refresh(nodes, partitions)
            if self.admission is not None:
                # in-flight fast-path binds (not yet visible agent-side)
                # come straight off the solve's free view, so the batch
                # tick can never double-claim fast-claimed capacity;
                # ``free`` is a per-solve copy, the caches are untouched
                name_idx0 = self._encoded.name_idx
                for _nm, (hint, dvec) in sorted(
                    self.admission.deductions_copy().items()
                ):
                    for h in hint:
                        pos = name_idx0.get(h)
                        if pos is not None:
                            snapshot.free[pos] -= dvec
            self._prune_demand_keys(all_pods)
            batch = self._job_rows.encode(
                [self._demand_key(p) for p in all_pods],
                demands,
                snapshot,
                codes_token=self._encoded.codes_token(),
                priorities=priorities,
            )
            enc_span.count("rows", int(batch.num_shards))
            enc_span.count("jobs", len(all_pods))
        enc_s = enc_span.duration
        self.last_phase_ms["encode"] = enc_s * 1e3
        _encode_seconds.observe(enc_s)

        # Streaming incumbents: pin each already-submitted shard to its
        # hinted node and release its RUNNING usage so everyone re-admits
        # against total capacity (solver/streaming.py semantics).
        name_idx = self._encoded.name_idx
        incumbent_arr = np.full(batch.num_shards, -1, np.int32)
        shard_rows: dict[int, list[int]] = {}
        for row in range(batch.num_shards):
            shard_rows.setdefault(int(batch.job_of[row]), []).append(row)
        for j in range(n_pending, len(all_pods)):
            pod = all_pods[j]
            hints = (
                pod.hint
                if isinstance(pod, _RowPod)
                else pod.spec.placement_hint
            )
            rows = shard_rows.get(j, [])
            for k, row in enumerate(rows):
                node = name_idx.get(hints[k]) if k < len(hints) else None
                if node is not None:
                    incumbent_arr[row] = node
                    # release EVERY incumbent's usage, not just visibly
                    # RUNNING ones: the pod phase lags Slurm's allocation,
                    # and an unreleased-but-allocated incumbent would pin
                    # to a node with zero modeled free capacity and be
                    # spuriously preempted. Transient over-release (job
                    # still queued in Slurm) only delays a preemption by a
                    # tick; the level-triggered loop self-corrects.
                    snapshot.free[node] += batch.demand[row]
                else:
                    # hint node vanished from the inventory (drained mid-
                    # run): take the shard out of the solve entirely —
                    # unpinned it would shadow healthy nodes' capacity
                    # without being bindable or preemptible
                    batch.partition_of[row] = PAD_PARTITION
                    batch.demand[row] = 0.0
        if n_pending < len(all_pods):
            # half-step boost: CR priorities are integers, so this flips
            # only exact ties — an equal-priority newcomer must NOT displace
            # running work (admission sorts pending rows first otherwise)
            batch.priority[batch.job_of >= n_pending] += 0.5

        syncs0 = auction.HOST_SYNCS
        with TRACER.span("scheduler.solve") as solve_span:
            placement = self._solve(snapshot, batch, incumbent_arr)
            solve_span.set_tag("engine", self.last_route)
            solve_span.count("shards", int(batch.num_shards))
            self.last_host_syncs = auction.HOST_SYNCS - syncs0
            solve_span.count("host_syncs", self.last_host_syncs)
        solve_s = solve_span.duration
        self.last_phase_ms["solve"] = solve_s * 1e3
        _solve_seconds.observe(solve_s)
        by_job = placement.by_job(batch)
        backfill_takes: list[tuple[int, int]] = []
        if self.policy is not None and self.policy.config.backfill:
            # cheap second pass: whatever the solve left unplaced —
            # singles and whole gangs, all-or-nothing — into its
            # leftover holes, guarded against delaying any other
            # unplaced equal-or-higher-class gang (policy/engine.py)
            backfill_takes = self.policy.backfill(
                snapshot, batch, placement, n_pending
            )
            for row, node in backfill_takes:
                by_job.setdefault(int(batch.job_of[row]), []).append(node)
        if self.admission is not None:
            # the residual seam: what this solve left free AFTER
            # backfill is what the fast path may admit against — with
            # this tick's pending binds re-subtracted at the workload
            # manager's INTEGRAL granularity (Slurm allocates whole
            # cpus/MBs per node; the float model's under-count would
            # let the window overstate free capacity the moment the
            # binds start)
            residual = placement.free_after.copy()
            placed_pend = np.nonzero(
                placement.placed & (batch.job_of < n_pending)
            )[0]
            if placed_pend.size:
                adj = (
                    np.ceil(batch.demand[placed_pend])
                    - batch.demand[placed_pend]
                )
                np.subtract.at(
                    residual, placement.node_of[placed_pend], adj
                )
            for row, node in backfill_takes:
                residual[node] -= np.ceil(batch.demand[row])
            self._adm_capture = (snapshot, residual, None)
        if self.explain:
            self._capture_explain_local(
                snapshot, batch, placement, backfill_takes, by_job,
                shard_rows, demands, n_pending,
            )
        by_job_names = {
            j: [snapshot.node_names[i] for i in idxs] for j, idxs in by_job.items()
        }
        lost_jobs = [
            j
            for j in range(n_pending, len(all_pods))
            if any(
                incumbent_arr[r] >= 0 and placement.node_of[r] != incumbent_arr[r]
                for r in shard_rows.get(j, [])
            )
        ]
        return by_job_names, lost_jobs

    def _solve_sharded(
        self, partitions, nodes, demands, all_pods, n_pending,
        priorities=None, trail=None, trail_job=-1,
    ) -> tuple[dict[int, list[str]], list[int]]:
        """The sharded tick: plan → route → per-shard encode+solve →
        merge → cross-shard gang reconciliation (slurm_bridge_tpu_torch.shard).

        Per-shard encode runs inside the executor (per-shard
        ``EncodedInventory``/``JobRowCache``), so the phase clock books
        the executor's measured encode slice under ``encode`` and the
        remainder — solves, merge, reconcile — under ``solve``; the
        per-shard spans carry the fine breakdown for the flight record.
        Policy effective priorities were computed GLOBALLY by
        ``policy.prepare`` before this call and are applied per shard by
        index slice — class dominance and the fair order survive the
        fan-out unchanged.
        """
        self._prune_demand_keys(all_pods)
        self.solves_total += 1
        with TRACER.span("scheduler.solve", engine="sharded") as solve_span:
            by_job_names, lost_jobs = self.shard.solve(
                partitions, nodes, demands, all_pods, n_pending,
                priorities=priorities,
                demand_key=self._demand_key,
                policy=self.policy,
                deductions=(
                    self.admission.deductions_copy()
                    if self.admission is not None
                    else None
                ),
                capture_residual=self.admission is not None,
                explain=self.explain,
                trail=trail,
                trail_job=trail_job,
            )
            if self.admission is not None and self.shard.last_window is not None:
                self._adm_capture = self.shard.last_window
            if self.explain:
                self._explain_ctx = self.shard.last_explain_inputs
                self._explain_memo = None
            solve_span.count("shards_used", self.shard.last_shards_used)
            solve_span.count(
                "reconciled", self.shard.last_reconcile_placed
            )
        solve_s = solve_span.duration
        enc_ms = self.shard.last_encode_ms
        self.last_phase_ms["encode"] = enc_ms
        self.last_phase_ms["solve"] = max(0.0, solve_s * 1e3 - enc_ms)
        _encode_seconds.observe(enc_ms / 1e3)
        _solve_seconds.observe(max(0.0, solve_s - enc_ms / 1e3))
        self.last_route = "sharded"
        _route_total.inc(engine="sharded")
        return by_job_names, lost_jobs

    def _solve_remote(
        self, partitions, nodes, demands, all_pods, n_pending,
        priorities=None,
    ) -> tuple[dict[int, list[str]], list[int]] | None:
        """Out-of-process solve via the PlacementSolver sidecar.

        The sidecar owns the streaming-incumbent semantics (release usage,
        pin shards, +0.5 tie-break — solver/service.py), so this path only
        lowers demands to PlaceJobs and reads assignments back. Gangs admit
        all-or-nothing, so a preempted incumbent simply has no node_names in
        the response — unless every hinted node vanished from the inventory,
        which the local path treats as "drop the shards, keep the pod".

        ``priorities`` (policy ticks) ride each PlaceJob as
        ``priority_override`` (PR-10): the sidecar admits by the
        bridge's globally-computed effective priorities, so class
        dominance and the fair-share order are enforced inside the
        remote solve exactly like the in-process one.
        """
        from slurm_bridge_tpu_torch.wire.convert import (
            auction_config_to_proto,
            demand_to_place,
            node_to_proto,
            partition_to_proto,
        )

        # a remote solve ships no residual artifacts back — attribution
        # degrades to the generic UNKNOWN verdict for these ticks
        self._explain_ctx = None
        self._explain_memo = None
        jobs = []
        for j, d in enumerate(demands):
            job = demand_to_place(d, job_id=str(j))
            if j >= n_pending:
                job.incumbent_node_names.extend(all_pods[j].hint)
            if priorities is not None:
                job.priority_override = float(priorities[j])
                job.has_priority_override = True
            jobs.append(job)
        try:
            resp = self._remote.Place(
                pb.PlaceRequest(
                    jobs=jobs,
                    inventory=[node_to_proto(n) for n in nodes],
                    partitions=[partition_to_proto(p) for p in partitions],
                    # greedy stays greedy; "auto" gets the full routing rule
                    # (indexed packer included); an explicit auction pin
                    # sends "" = device-family auto (auction vs sharded
                    # only), preserving the operator's quality choice
                    solver=(
                        self.backend if self.backend == "greedy"
                        else "auto" if self.backend == "auto"
                        else ""
                    ),
                    # an explicitly tuned config rides along — the sidecar
                    # must not silently solve with its own defaults; an
                    # UNtuned bridge sends none, so a tuned sidecar keeps
                    # its launch-time knobs (ADVICE r3, both directions)
                    config=(
                        auction_config_to_proto(self.auction_config)
                        if self._explicit_config
                        else None
                    ),
                ),
                timeout=self.place_timeout,
            )
        except RpcError as e:
            log.warning("remote Place failed (%s); skipping tick", e.code())
            return None  # tick() skips binding/preemption entirely
        # the sidecar reports which engine it ran — count the tick under it
        # so the route metric covers sidecar deployments too
        self.last_route = f"remote-{resp.solver}"
        _route_total.inc(engine=self.last_route)
        if self.admission is not None and resp.free_after:
            # the sidecar's residual (ISSUE 16): seed the fast-path
            # window from the remote solve's own free_after instead of
            # leaving streaming admission dark on sidecar deployments.
            # The sidecar computes against the same wire inventory in
            # the same node order, so a local re-encode keys the window
            # to a snapshot whose node_names match the vector's rows;
            # an older sidecar sends nothing and the window stays on
            # its previous base (pre-16 behavior).
            from slurm_bridge_tpu_torch.solver.snapshot import encode_cluster

            snapshot = encode_cluster(list(nodes), list(partitions))
            residual = np.asarray(resp.free_after, np.float32)
            if residual.size == snapshot.free.size:
                self._adm_capture = (
                    snapshot,
                    residual.reshape(snapshot.free.shape),
                    None,
                )
            else:
                log.warning(
                    "remote Place free_after has %d entries, want %d; "
                    "ignoring", residual.size, snapshot.free.size,
                )
        by_job_names = {
            int(a.job_id): list(a.node_names)
            for a in resp.assignments
            if a.node_names
        }
        known = set()
        for n in nodes:
            known.add(n.name)
        lost_jobs = [
            j
            for j in range(n_pending, len(all_pods))
            if j not in by_job_names
            and any(h in known for h in all_pods[j].hint)
        ]
        return by_job_names, lost_jobs

    def _use_sharded(self, batch, snapshot) -> bool:
        if self.sharded is not None:
            return self.sharded
        from slurm_bridge_tpu_torch.parallel.backend import ensure_backend
        from slurm_bridge_tpu_torch.parallel.mesh import device_count
        from slurm_bridge_tpu_torch.solver.routing import use_sharded

        return use_sharded(
            batch.num_shards, snapshot.num_nodes,
            device_count(ensure_backend(self.device)),
            self.sharded_threshold,
        )

    def _solve(self, snapshot, batch, incumbent):
        if self.backend == "greedy":
            self.last_route = "greedy"
            _route_total.inc(engine="greedy")
            # pins must ride along: tick() gathers incumbents for every
            # backend now, and dropping them here would re-place running
            # jobs wherever best-fit likes — mass preemption every tick
            return greedy_place(snapshot, batch, incumbent=incumbent)
        # auto routing (VERDICT r3 #5): a solve below the device dispatch
        # floor — or any solve without an accelerator — goes to the indexed
        # native packer (greedy-parity quality, no dispatch round-trip).
        # Incumbent-bearing ticks ride it too since round 5 (VERDICT r4 #1:
        # the packer honours pins, so a CPU-only host no longer pays the
        # JAX sampled auction ~957 ms/tick for the steady-state loop).
        if self.backend == "auto":
            from slurm_bridge_tpu_torch.solver.routing import (
                choose_path,
                gang_shard_fraction,
                incumbent_fraction,
            )

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
                from slurm_bridge_tpu_torch.solver.routing import native_fit_policy

                self.last_route = "native"
                _route_total.inc(engine="native")
                return indexed_place_native(
                    snapshot,
                    batch,
                    incumbent=incumbent,
                    policy=native_fit_policy(bool((incumbent >= 0).any())),
                )
        p_real = batch.num_shards
        if self.bucket:
            batch = pad_batch(batch, self.bucket)
            if batch.num_shards != p_real:
                incumbent = np.concatenate(
                    [incumbent, np.full(batch.num_shards - p_real, -1, np.int32)]
                )
        if self._use_sharded(batch, snapshot):
            from slurm_bridge_tpu_torch.solver.sharded import sharded_place

            self.last_route = "auction-sharded"
            placement = sharded_place(
                snapshot, batch, self.auction_config, incumbent=incumbent,
                device=self.device,
            )
        else:
            self.last_route = "auction"
            if self._solver is None:
                self._solver = DeviceSolver(
                    snapshot, self.auction_config, device=self.device
                )
            else:
                self._solver.update_snapshot(snapshot)
            placement = self._solver.solve(batch, incumbent=incumbent)
        if placement.node_of.shape[0] != p_real:
            placement = Placement(
                node_of=placement.node_of[:p_real],
                placed=placement.placed[:p_real],
                free_after=placement.free_after,
            )
        _route_total.inc(engine=self.last_route)
        return placement

    # ---- streaming admission (ISSUE 12 tentpole) ----

    def _prune_deductions(self) -> None:
        """Drop in-flight fast-bind deductions whose pod is now visible
        agent-side (job ids recorded — Slurm arbitrates from here), or
        vanished/unbound (nothing left to deduct). Driven per tick off
        the pods themselves, not a timer."""
        adm = self.admission
        with adm.lock:
            if not adm.deductions:
                return
            table = self.store.table(Pod.KIND)
            drops: list[str] = []
            if table is not None:
                with self.store.locked():
                    c = table.cols
                    for name in adm.deductions:
                        row = table.row_of.get(name)
                        if (
                            row is None
                            or c.deleted[row]
                            or not c.node[row]
                            or int(c.njobs[row]) > 0
                        ):
                            drops.append(name)
            else:
                for name in adm.deductions:
                    p = self.store.try_get(Pod.KIND, name)
                    if (
                        p is None
                        or p.meta.deleted
                        or not p.spec.node_name
                        or p.status.job_ids
                    ):
                        drops.append(name)
            for name in drops:
                adm.drop_deduction(name)

    def _rebase_admission_window(
        self, demands, by_job_names, n_pending
    ) -> None:
        """Re-base the fast path on this tick's solve: the residual
        free_after view plus the unplaced-gang backlog the no-delay
        guard protects. Runs after the bind commit, so arrivals between
        this tick and the next admit against exactly what the batch
        solve left behind."""
        cap = self._adm_capture
        if cap is None:
            return  # no in-process solve yet (cold start / remote)
        snapshot, residual, plan = cap
        backlog = []
        for j in range(n_pending):
            if j in by_job_names:
                continue
            d = demands[j]
            if d is None or max(1, d.nodes) <= 1:
                continue
            rank = (
                self.policy.class_rank_of_job(j)
                if self.policy is not None
                else 0
            )
            backlog.append((d, rank))
        self.admission.begin_window(snapshot, residual, backlog, plan=plan)

    # ---- placement explainability (ISSUE 15) ----

    def _part_members_of(self, snapshot) -> dict:
        """Partition name → member node positions for one snapshot —
        memoized on snapshot identity (the encoder replays the same
        snapshot object while the inventory is unchanged, so steady
        generations rebuild nothing)."""
        memo = self._pm_memo
        if memo is not None and memo[0] is snapshot:
            return memo[1]
        pof = snapshot.partition_of
        members = {
            name: np.nonzero(pof == code)[0]
            for name, code in snapshot.partition_codes.items()
        }
        self._pm_memo = (snapshot, members)
        return members

    def _capture_explain_local(
        self, snapshot, batch, placement, backfill_takes, by_job,
        shard_rows, demands, n_pending,
    ) -> None:
        """Package the monolithic solve's artifacts for attribution:
        the FLOAT-model residual after backfill (backfill's own model —
        the admission window's ceil-adjusted sibling is deliberately
        not reused) plus one record per unplaced pending job, read
        straight from the encoded batch rows."""
        jobs: list[explain_mod.UnplacedJob] = []
        for j in range(n_pending):
            if j in by_job:
                continue
            rows = shard_rows.get(j)
            if not rows:
                continue
            r0 = rows[0]
            jobs.append(
                explain_mod.UnplacedJob(
                    j=j,
                    partition=demands[j].partition,
                    d=batch.demand[r0].copy(),
                    need=len(rows),
                    req=int(batch.req_features[r0]),
                )
            )
        if not jobs:
            # everything placed: no residual copy, no member-index
            # build — a fully-placed tick pays the scan above and
            # nothing else
            self._explain_ctx = None
            self._explain_memo = None
            return
        residual = placement.free_after.copy()
        for row, node in backfill_takes:
            residual[node] -= batch.demand[row]
        self._explain_ctx = explain_mod.ExplainInputs(
            free=residual,
            capacity=snapshot.capacity,
            features=snapshot.features,
            part_members=self._part_members_of(snapshot),
            jobs=jobs,
        )
        self._explain_memo = None

    def _explain_codes(
        self, pods, demands, by_job_names, n_pending
    ) -> dict[int, str]:
        """Attribute a primary reason code to every unplaced pending
        job, from the last fresh solve's captured artifacts. Memoized on
        (inputs, assignment) identity — a warm-start memo tick re-marks
        the identical backlog, so attribution is pure replay."""
        ctx = self._explain_ctx
        if ctx is None:
            return {}
        memo = self._explain_memo
        if memo is not None and memo[0] is ctx and memo[1] is by_job_names:
            return memo[2]
        pol = None
        if self.policy is not None:
            pol = explain_mod.PolicyContext(
                ranks=[
                    self.policy.class_rank_of_job(j)
                    for j in range(n_pending)
                ],
                prios=[
                    float(demands[j].priority) if demands[j] is not None
                    else 0.0
                    for j in range(n_pending)
                ],
                parts=[demands[j].partition for j in range(n_pending)],
                placed={j for j in by_job_names if j < n_pending},
                fair_share=self.policy.config.fair_share,
                preempt_excluded=dict(
                    self.policy.pool_excluded_rank_by_part
                ),
            )
        codes = explain_mod.attribute(ctx, pol)
        self._explain_memo = (ctx, by_job_names, codes)
        return codes

    def _build_pressure_ledger(self, ledger_rows: list) -> dict:
        """The per-tick pressure ledger from the bind loop's attribution
        rows ``(job index, code, partition, labels)``; class/tenant
        resolve through the policy's own table (policy-off ticks carry
        empty class/tenant cells). Published to /debug/schedz when
        anything is actually unplaced."""
        from slurm_bridge_tpu_torch.policy.classes import TENANT_LABEL

        shard_of = (
            {job.j: job.shard for job in self._explain_ctx.jobs}
            if self._explain_ctx is not None
            else {}
        )
        table = self.policy.table if self.policy is not None else None
        rows = []
        for j, code, partition, labels in ledger_rows:
            cls = table.resolve(labels).name if table is not None else ""
            tenant = (labels.get(TENANT_LABEL, "") if labels else "") or ""
            rows.append((code, partition, cls, tenant, shard_of.get(j, -1)))
        led = explain_mod.build_ledger(rows)
        if led["unplaced"]:
            explain_mod.SCHEDZ.publish(led)
        return led

    def _unsubmitted_bind_nodes(self) -> set[str]:
        """Hint nodes of store-BOUND sizecar pods whose submission has
        not reached the agent yet (``job_ids`` empty): the agent still
        reports their capacity free, but a solve residual already
        committed it — the inventory re-base must not raise those rows
        (the double-claim direction). One vectorized column mask on the
        columnar store; the object fallback scans the bound buckets."""
        out: set[str] = set()
        table = self.store.table(Pod.KIND)
        if table is not None:
            c = table.cols
            with self.store.locked():
                if not table.row_of:
                    return out
                rows = np.fromiter(
                    table.row_of.values(), np.int64, len(table.row_of)
                )
                keep = (
                    (c.role[rows] == PodRole.SIZECAR)
                    & ~c.deleted[rows]
                    & (c.node[rows] != "")
                    & (c.njobs[rows] == 0)
                )
                for hints in c.hint[rows[keep]]:
                    out.update(hints)
            return out
        for p in self.store.list(Pod.KIND):
            if (
                p.spec.role == PodRole.SIZECAR
                and p.spec.node_name
                and not p.status.job_ids
                and not p.meta.deleted
            ):
                out.update(p.spec.placement_hint)
        return out

    def note_inventory(self, partition: str, nodes) -> None:
        """Maintain the streaming-admission window from a provider's
        periodic inventory probe (ROADMAP follow-up c): on ticks where
        no solve re-based the window — an idle cluster, the steady-bind
        skip — completions the agent already reports re-open fast-path
        capacity WITHOUT waiting for the next solve. The admitter gates
        the re-base under its own lock (solve ticks forbid it: a
        provider probes BEFORE converging its submits, so its view
        predates the tick's binds), and nodes holding bound-but-not-yet
        -submitted pods keep the window's conservative rows."""
        adm = self.admission
        if adm is None:
            return
        adm.rebase_from_inventory(
            nodes, skip_nodes=self._unsubmitted_bind_nodes()
        )

    def admit(self, name: str):
        """One streaming-admission attempt for a pending pod — the fast
        path's public entry, called at ARRIVAL time (event-driven), not
        from the tick. Interactive-class singles and small gangs bind
        immediately against the residual view when a tight fit exists
        under backfill's no-delay guard; everything else (and every
        miss) falls through to the normal pending scan untouched."""
        from slurm_bridge_tpu_torch.admission.fastpath import AdmitResult

        adm = self.admission
        if adm is None:
            return AdmitResult(eligible=False)
        t0 = time.perf_counter()
        pod = self.store.try_get(Pod.KIND, name)
        if (
            pod is None
            or pod.meta.deleted
            or pod.spec.role != PodRole.SIZECAR
            or pod.spec.node_name
            or pod.status.phase != PodPhase.PENDING
        ):
            return AdmitResult(eligible=False)
        demand = pod.spec.demand
        rank = adm.eligibility_rank(pod.meta.labels, demand)
        trail = self.explain_trail
        if trail is not None and not trail.matches(name):
            trail = None
        if rank is None:
            if trail is not None:
                trail.add(
                    "admission",
                    "not fast-path eligible (class/gang size); waits for "
                    "the batch tick",
                )
            return AdmitResult(eligible=False)
        with TRACER.span("admission.fastpath") as span:
            # one critical section from reservation to commit: arrivals
            # may run off the tick thread, and the tick's prune/
            # subtract/re-base seams serialize on the same lock
            with adm.lock:
                vn = self.store.try_get(
                    VirtualNode.KIND, partition_node_name(demand.partition)
                )
                if vn is None or not vn.ready or vn.meta.deleted:
                    # same gate as the batch bind phase's ready check
                    reason = adm.miss_only("not_ready")
                    span.set_tag("outcome", reason)
                    out = AdmitResult(eligible=True, reason=reason)
                else:
                    names, reason, token = adm.admit(demand, rank)
                    if names and self._bind(
                        name, partition_node_name(demand.partition), names
                    ):
                        adm.note_bound(name, names, token)
                        if self.policy is not None:
                            # fair share stays honest across both paths;
                            # the ledger persists at the next tick's save
                            self.policy.charge_admission(
                                pod.meta.labels, demand
                            )
                        span.set_tag("outcome", "bound")
                        span.count("bound", 1)
                        out = AdmitResult(eligible=True, hint=names)
                    else:
                        if names:
                            # store-bind conflict: release the reservation
                            adm.rollback(token)
                            reason = "conflict"
                        span.set_tag("outcome", reason)
                        out = AdmitResult(eligible=True, reason=reason)
        adm.observe_latency(time.perf_counter() - t0)
        if trail is not None:
            if out.bound:
                trail.add(
                    "admission", f"fast-bound to nodes {','.join(out.hint)}"
                )
            else:
                trail.add(
                    "admission",
                    f"fast-path miss ({out.reason}); falls through to the "
                    "batch tick",
                )
        return out

    def _preempt(self, pod: Pod) -> bool:
        """Requeue a preempted pod, then cancel its jobs: binding cleared,
        submit generation bumped so the agent's dedupe ledger accepts the
        resubmission as new work.

        Reset-before-cancel ordering matters: once job_ids are cleared the
        virtual node stops syncing Slurm state into the pod, so the
        CANCELLED terminal state can never race the requeue into a Failed
        CR (vnode._refresh_status also guards on the ids it queried).
        """
        job_ids: list[int] = []

        def record(p: Pod):
            job_ids.clear()  # fresh per mutate attempt (Conflict retries)
            if not p.status.job_ids:
                return False  # already reset by someone else
            job_ids.extend(p.status.job_ids)
            gen = int(p.meta.annotations.get("submit-generation", "0")) + 1
            p.meta.annotations["submit-generation"] = str(gen)
            p.spec.node_name = ""
            p.spec.placement_hint = ()
            p.status.job_ids = ()
            p.status.job_infos = []
            p.status.phase = PodPhase.PENDING
            p.status.reason = "Preempted: displaced by higher-priority work"

        try:
            self.store.mutate(Pod.KIND, pod.name, record, site="scheduler.preempt")
        except NotFound:
            return False
        if not job_ids:
            return False
        failed = self._cancel_jobs(job_ids, context="preempt")
        if failed:
            self._record_pending_cancels(pod.name, failed)
        self.events.emit(
            Pod.KIND, pod.name, Reason.PLACEMENT_FAILED,
            "preempted: displaced by higher-priority work", warning=True,
        )
        return True

    def _cancel_jobs(
        self, job_ids: list[int], *, context: str, timeout: float | None = None
    ) -> list[int]:
        """CancelJob each id; returns the ids whose cancel failed.

        Retry-context cancels pass a short ``timeout`` so a dead agent
        costs the tick at most timeout × backlog, not the default RPC
        deadline × backlog (ADVICE r2)."""
        failed: list[int] = []
        for job_id in job_ids:
            try:
                self.client.CancelJob(
                    pb.CancelJobRequest(job_id=job_id), timeout=timeout
                )
            except RpcError as e:
                log.warning(
                    "%s: cancel job %d failed (will retry next tick): %s",
                    context, job_id, e.details(),
                )
                failed.append(job_id)
        return failed

    def _record_pending_cancels(self, pod_name: str, job_ids: list[int]) -> None:
        """Persist failed cancels on the pod so they survive restarts and
        are retried every tick (ADVICE r1: never drop a cancel after one
        attempt — an orphaned Slurm job double-executes the workload)."""

        def record(p: Pod):
            existing = p.meta.annotations.get(PENDING_CANCEL_ANNOTATION, "")
            ids = {int(t) for t in existing.split(",") if t}
            ids.update(job_ids)
            p.meta.annotations[PENDING_CANCEL_ANNOTATION] = ",".join(
                str(i) for i in sorted(ids)
            )

        try:
            self.store.mutate(Pod.KIND, pod_name, record, site="scheduler.cancel")
        except NotFound:
            self._orphan_cancels.update(job_ids)

    def _retry_pending_cancels(self) -> None:
        """Drain the pending-cancel backlog at the top of every tick."""
        tmo = self.retry_cancel_timeout
        if self._orphan_cancels:
            still = self._cancel_jobs(
                sorted(self._orphan_cancels), context="retry", timeout=tmo
            )
            self._orphan_cancels = set(still)
        # dirty-set scan (changes_since): only pods written since the last
        # tick can have gained or shed the annotation
        rv, changed, deleted = self.store.changes_since(
            Pod.KIND, self._cancel_scan_rv
        )
        self._cancel_scan_rv = rv
        for name in deleted:
            self._pending_cancel_pods.discard(name)
        table = self.store.table(Pod.KIND)
        if table is not None:
            # annotation probe straight from the ann column — the changed
            # set is ~every pod on a cold tick, and materializing 50k
            # frozen views to read one (usually absent) annotation was
            # a third of the store phase
            add, discard = (
                self._pending_cancel_pods.add,
                self._pending_cancel_pods.discard,
            )
            with self.store.locked():
                row_of, ann_col = table.row_of, table.cols.ann
                for name in changed:
                    row = row_of.get(name)
                    ann = ann_col[row] if row is not None else None
                    if ann and ann.get(PENDING_CANCEL_ANNOTATION):
                        add(name)
                    else:
                        discard(name)
        else:
            for name in changed:
                p = self.store.try_get(Pod.KIND, name)
                if p is not None and p.meta.annotations.get(
                    PENDING_CANCEL_ANNOTATION
                ):
                    self._pending_cancel_pods.add(name)
                else:
                    self._pending_cancel_pods.discard(name)
        for name in sorted(self._pending_cancel_pods):
            pod = self.store.try_get(Pod.KIND, name)
            pending = (
                pod.meta.annotations.get(PENDING_CANCEL_ANNOTATION)
                if pod is not None
                else None
            )
            if not pending:
                self._pending_cancel_pods.discard(name)
                continue
            ids = [int(t) for t in pending.split(",") if t]
            still = set(self._cancel_jobs(ids, context="retry", timeout=tmo))
            if len(still) == len(ids):
                continue  # nothing landed; annotation already correct
            landed = set(ids) - still

            def record(p: Pod):
                # derive from the pod's CURRENT annotation, removing only
                # the ids whose cancel landed — a conflict-retry (or a
                # concurrent writer adding fresh pending-cancel ids) must
                # not be clobbered by a precomputed value (ADVICE r2)
                current = p.meta.annotations.get(PENDING_CANCEL_ANNOTATION, "")
                remaining = {int(x) for x in current.split(",") if x} - landed
                if remaining:
                    p.meta.annotations[PENDING_CANCEL_ANNOTATION] = ",".join(
                        str(i) for i in sorted(remaining)
                    )
                else:
                    p.meta.annotations.pop(PENDING_CANCEL_ANNOTATION, None)

            try:
                self.store.mutate(Pod.KIND, pod.name, record, site="scheduler.cancel")
            except NotFound:
                self._orphan_cancels.update(still)

    def _bind_batch(self, binds: list[tuple[Pod, str, tuple[str, ...]]]) -> int:
        """Commit every bind of the tick under ONE store lock acquisition.

        Each replacement pod is built with ``dataclasses.replace`` so
        unchanged frozen sub-objects (demand, labels, job_infos) are
        structurally shared instead of deep-copied — at the headline shape
        this turned a 13.7 s bind phase of 45k mutate() round-trips into
        one ``update_batch``. The optimistic resource_version carried from
        the pending read is exactly the old mutate guard: ANY interim
        write (a concurrent bind, a deletion mark) conflicts, and the
        loser falls back to the single-pod read-modify-write path.
        """
        if not binds:
            return 0
        table = self.store.table(Pod.KIND)
        if table is not None:
            return self._bind_batch_cols(table, binds)
        updated = [
            fast_replace(
                pod.obj,
                meta=fast_replace(pod.obj.meta),
                # spec/status born frozen (changed values are scalars):
                # the 45k-write commit walk stops at meta
                spec=frozen_replace(
                    pod.obj.spec, node_name=node_name, placement_hint=hint
                ),
                status=frozen_replace(pod.obj.status, reason=""),
            )
            for pod, node_name, hint in binds
        ]
        results = self.store.update_batch(updated, site="scheduler.bind")
        placed = 0
        for (pod, node_name, hint), res in zip(binds, results):
            if isinstance(res, Exception):
                if self._bind(pod.name, node_name, hint):
                    placed += 1
                continue
            placed += 1
            self.events.emit(
                Pod.KIND, pod.name, Reason.PLACEMENT_OK,
                f"bound to {node_name} (nodes {','.join(hint)})",
            )
        return placed

    def _bind_batch_cols(
        self, table, binds: list[tuple[_RowPod, str, tuple[str, ...]]]
    ) -> int:
        """The bind commit as ONE columnar row-write: node/hint/reason
        land straight in columns (``node_to`` drives the node-index
        moves), so the 45k-bind cold tick builds zero frozen replacement
        pods. Conflicts and vanished pods fall back to the per-pod
        optimistic path, exactly like the object-batch form."""
        from slurm_bridge_tpu_torch.bridge.colstore import object_array

        c = table.cols
        n = len(binds)
        names = [pod.name for pod, _, _ in binds]
        expected = np.fromiter((pod.rv for pod, _, _ in binds), np.int64, n)
        node_to = object_array([node_name for _, node_name, _ in binds])
        hints = object_array([hint for _, _, hint in binds])

        def writer(rws, sel):
            c.hint[rws] = hints[sel]
            c.reason[rws] = ""

        results = self.store.update_rows(
            Pod.KIND, names, expected, writer,
            site="scheduler.bind", node_to=node_to,
        )
        placed = 0
        ok_pairs: list[tuple[str, str]] = []
        for (pod, node_name, hint), rc in zip(binds, results.tolist()):
            if rc == 0:
                continue  # vanished mid-tick: the per-pod path would NotFound
            if rc < 0:
                if self._bind(pod.name, node_name, hint):
                    placed += 1
                continue
            placed += 1
            ok_pairs.append(
                (pod.name, f"bound to {node_name} (nodes {','.join(hint)})")
            )
        self.events.emit_batch(Pod.KIND, Reason.PLACEMENT_OK, ok_pairs)
        return placed

    def _bind(self, name: str, node_name: str, hint: tuple[str, ...]) -> bool:
        bound = [False]
        try:

            def record(p: Pod):
                bound[0] = False
                if p.spec.node_name or p.meta.deleted:
                    return False  # someone else bound or deleted it
                p.spec.node_name = node_name
                p.spec.placement_hint = hint
                p.status.reason = ""
                bound[0] = True

            self.store.mutate(Pod.KIND, name, record, site="scheduler.bind")
        except NotFound:
            return False
        if not bound[0]:
            return False
        self.events.emit(
            Pod.KIND, name, Reason.PLACEMENT_OK,
            f"bound to {node_name} (nodes {','.join(hint)})",
        )
        return True

    def _mark_unschedulable_batch(
        self, marks: list[tuple[Pod, str]], *, emit_all: bool = True
    ) -> None:
        """PLACEMENT_FAILED recording for every unplaced pod of the tick
        in ONE ``update_batch`` (PR-4): the very first cold-start tick
        marks the ENTIRE backlog unschedulable (no virtual node is ready
        yet), which used to cost one locked read-modify-write per pod —
        3.6 s of the 50k-pod tick. Writes land only where the reason
        actually changed; the warning event fires per pod either way,
        exactly like the per-pod form."""
        if not marks:
            return
        changed = [(p, r) for p, r in marks if p.reason != r]
        skip_event: set[str] = set()
        table = self.store.table(Pod.KIND)
        if changed and table is not None:
            from slurm_bridge_tpu_torch.bridge.colstore import object_array

            c = table.cols
            reasons = object_array([r for _, r in changed])

            def writer(rws, sel):
                c.reason[rws] = reasons[sel]

            results = self.store.update_rows(
                Pod.KIND,
                [p.name for p, _ in changed],
                np.fromiter(
                    (p.rv for p, _ in changed), np.int64, len(changed)
                ),
                writer,
                site="scheduler.unschedulable",
            )
            for (pod, reason), rc in zip(changed, results.tolist()):
                if rc == 0:
                    skip_event.add(pod.name)  # deleted mid-tick: no event
                elif rc < 0:
                    # racing writer: the per-pod optimistic retry (which
                    # emits its own event on success)
                    skip_event.add(pod.name)
                    self._mark_unschedulable(pod.name, reason)
        elif changed:
            results = self.store.update_batch(
                [
                    fast_replace(
                        pod.obj,
                        meta=fast_replace(pod.obj.meta),
                        status=frozen_replace(pod.obj.status, reason=reason),
                    )
                    for pod, reason in changed
                ],
                site="scheduler.unschedulable",
            )
            for (pod, reason), res in zip(changed, results):
                if isinstance(res, NotFound):
                    skip_event.add(pod.name)  # deleted mid-tick: no event
                elif isinstance(res, Exception):
                    # racing writer: the per-pod optimistic retry (which
                    # emits its own event on success)
                    skip_event.add(pod.name)
                    self._mark_unschedulable(pod.name, reason)
        # ``emit_all=False`` is the versioned mark (satellite b): within
        # one backlog generation each (pod, reason) warns exactly once —
        # the caller resets the ledger whenever a fresh solve opens a
        # new generation, restoring the level-triggered re-emission
        pairs = [
            (pod.name, reason)
            for pod, reason in marks
            if pod.name not in skip_event
            and (emit_all or self._unsched_emitted.get(pod.name) != reason)
        ]
        if not emit_all:
            for name, reason in pairs:
                self._unsched_emitted[name] = reason
        self.events.emit_batch(
            Pod.KIND, Reason.PLACEMENT_FAILED, pairs, warning=True
        )

    def _mark_unschedulable(self, name: str, reason: str) -> None:
        try:

            def build(p: Pod):
                if p.status.reason == reason:
                    return None
                return fast_replace(
                    p,
                    meta=fast_replace(p.meta),
                    status=frozen_replace(p.status, reason=reason),
                )

            self.store.replace_update(
                Pod.KIND, name, build, site="scheduler.unschedulable"
            )
        except NotFound:
            return
        self.events.emit(
            Pod.KIND, name, Reason.PLACEMENT_FAILED, reason, warning=True
        )
