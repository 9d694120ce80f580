"""Virtual node provider — one partition mirrored as a schedulable node.

Reference parity: pkg/slurm-virtual-kubelet/. One provider per partition
(the configurator's horizontal sharding, SURVEY.md §2.9) that:

- registers a node whose capacity is the summed live partition inventory
  (node.go:18-52, GetPartitionCapacity :169-199 — fixing the reference's
  ``allogpu += node.AlloCpus`` bug :189);
- intercepts sizecar pods bound to it and submits them to Slurm with the
  pod UID as the idempotency token (provider.go:35-60, :414-434);
- converts live job state into pod status each sync (provider.go:195-219,
  status.go) — via the typed ``PodStatus.job_infos`` field instead of the
  JSON-in-Status.Message side-channel;
- cancels all owned jobs on pod deletion (provider.go:156-181);
- streams job logs: TailFile while running+follow, OpenFile otherwise
  (provider.go:246-302, reader.go).
"""

from __future__ import annotations

import bisect
import dataclasses
import logging
import threading
import time
from typing import Iterator, NamedTuple

import numpy as np

from slurm_bridge_tpu_torch.bridge import colstore
from slurm_bridge_tpu_torch.bridge.columns import (
    LAZY_DT,
    PHASE_CODE,
    PHASE_OF_SINGLE_STATE,
    SIGNAL_COLS,
    ColdecScratch,
    InfoScratch,
)
from slurm_bridge_tpu_torch.bridge.objects import (
    Meta,
    NodeCondition,
    Pod,
    PodPhase,
    PodRole,
    VirtualNode,
    partition_node_name,
)
from slurm_bridge_tpu_torch.bridge.freeze import (
    FrozenDict,
    FrozenList,
    fast_replace,
    frozen_new,
    frozen_replace,
)
from slurm_bridge_tpu_torch.bridge.statusmap import pod_phase_for
from slurm_bridge_tpu_torch.bridge.store import (
    AlreadyExists,
    NotFound,
    ObjectStore,
    frame_fallback_counter,
)
from slurm_bridge_tpu_torch.core.arrays import array_len
from slurm_bridge_tpu_torch.core.types import JobInfo, JobStatus, NodeInfo, PartitionInfo
from slurm_bridge_tpu_torch.obs.events import EventRecorder, Reason
from slurm_bridge_tpu_torch.obs.metrics import REGISTRY
from slurm_bridge_tpu_torch.obs.tracing import TRACER, with_current_span
from slurm_bridge_tpu_torch.parallel import colpool, writeops
from slurm_bridge_tpu_torch.wire import RpcError, ServiceClient, StatusCode, pb
from slurm_bridge_tpu_torch.wire import coldec
from slurm_bridge_tpu_torch.wire.convert import (
    NodesDecodeCache,
    PartitionDecodeCache,
    demand_to_submit,
    fill_submit_request,
    job_info_from_proto,
    partition_from_proto,
)

log = logging.getLogger("sbt.vnode")

_sync_seconds = REGISTRY.histogram(
    "sbt_provider_sync_seconds",
    "one provider sync tick: node refresh + pod converge + status mirror",
)
_status_seconds = REGISTRY.histogram(
    "sbt_provider_status_seconds",
    "the bulk status-mirror phase of a provider sync tick",
)
_bulk_queries = REGISTRY.counter(
    "sbt_provider_bulk_status_total", "batched JobsInfo queries issued"
)
_bulk_fallbacks = REGISTRY.counter(
    "sbt_provider_bulk_fallback_total",
    "provider ticks that fell back to per-pod JobInfo (agent lacks JobsInfo)",
)
_submit_bulk = REGISTRY.counter(
    "sbt_provider_submit_bulk_total", "batched SubmitJobs RPCs issued"
)
_submit_fallbacks = REGISTRY.counter(
    "sbt_provider_submit_fallback_total",
    "provider converges that submitted through the per-pod SubmitJob path "
    "(agent lacks SubmitJobs)",
)
_submit_pool_chunks = REGISTRY.counter(
    "sbt_vnode_submit_pool_chunks_total",
    "submit chunks whose SubmitJobsRequest bytes were encoded in colpool "
    "workers (ISSUE 18 write-side offload)",
)
_vector_diff_rows = REGISTRY.counter(
    "sbt_colstore_vector_diff_rows_total",
    "pod status rows diffed via the vectorized column compare",
)
_diff_fallback_rows = REGISTRY.counter(
    "sbt_colstore_diff_fallback_rows_total",
    "pod status rows that fell back to the per-object diff "
    "(multi-job pods, conflicts, odd segment shapes)",
)

#: bulk method → the raw-bytes client attribute the coldec path dials
#: (same RPC on the wire; identity response-deserializer client-side)
_BYTES_RPCS = {
    "JobsInfo": "JobsInfoBytes",
    "Nodes": "NodesBytes",
    "SubmitJobs": "SubmitJobsBytes",
}

#: pod-phase int8 codes the columnar classification uses
_PH_PENDING = PHASE_CODE["Pending"]
_PH_SUCCEEDED = PHASE_CODE["Succeeded"]
_PH_FAILED = PHASE_CODE["Failed"]

#: (heap column, scratch column) pairs for the vectorized status diff —
#: only the SIGNAL_COLS (columns.py): the fields Slurm can change on a
#: live job without a requeue. The always-ticking run_time counter is
#: deliberately absent (PR-3's "run_time ticking is not a change"), and
#: the immutable-once-submitted fields (user_id, workdir, nodelist, …)
#: are decoded and written only for rows whose signal fired.
_SIGNAL_DIFF_COLS = tuple((c, c) for c in SIGNAL_COLS)
#: columns written for a changed row — the full JobInfo field set
#: (run_time rides along, like the object path)
_WRITE_COLS = (
    ("id", "id"), ("user_id", "user_id"), ("name", "name"),
    ("exit_code", "exit_code"), ("state", "state"),
    ("submit_ts", "submit_ts"), ("start_ts", "start_ts"),
    ("limit", "limit"), ("workdir", "workdir"), ("stdout", "stdout"),
    ("stderr", "stderr"), ("partition", "partition"),
    ("nodelist", "nodelist"), ("batch_host", "batch_host"),
    ("num_nodes", "num_nodes"), ("array_id", "array_id"),
    ("reason", "reason"), ("run_time", "run_time"),
)


class _SubmitItem(NamedTuple):
    """One submit-eligible pod captured from columns — everything the
    batched submit path needs, no frozen view required."""

    name: str
    demand: object
    uid: str
    gen: str
    hint: tuple
    rv: int
    labels: dict
    ann: dict


class _RefreshBatch(NamedTuple):
    """The status-mirror working set captured from columns in one locked
    pass: names (name-sorted), per-pod job ids, and the stored row state
    to diff against. The info segments' offsets are not kept: a heap
    compaction moves them without a write, so the diff reads them under
    its own lock."""

    names: list
    job_ids: list
    rv: np.ndarray
    phase: np.ndarray
    ilen: np.ndarray


class _MirrorCache(NamedTuple):
    """The incremental mirror's cross-tick working set (PR-11): the last
    classification's refresh batch plus everything derived from it — the
    unique job-id list, the PRE-BUILT chunked ``JobsInfoRequest`` protos
    (``since_version`` is restamped per tick), and the job-id → pod
    names map that routes an agent-reported change back to its pod.
    Each sync patches it for the pods written since the last one (see
    :meth:`VirtualNodeProvider._rescope_mirror_cache`); a deletion, a
    member moving off the node or a member's job ids moving drop it and
    the node bucket is reclassified.
    """

    rb: _RefreshBatch
    #: the unique job ids (int64), in request order
    ids: np.ndarray
    reqs: list
    #: job id → names of the members holding it: keyed by name, so a
    #: join or leave renumbers no other member's entry
    names_of_jid: dict
    #: per-request flag: True = the chunk holds at least one job id this
    #: provider has NEVER applied a response for, so it must query at
    #: since_version=0. The trap it closes: a job submitted THIS tick
    #: carries a version the same tick's status pass already advanced the
    #: cursor past (the response version is global), and a cursor-scoped
    #: query would omit it until its NEXT transition — a RUNNING pod
    #: stuck visibly Pending. New ids sit in tail chunks (the id list is
    #: ordered applied-first), so one arrival re-queries one chunk, not
    #: the cluster.
    full_chunk: list
    #: pod name → batch index — the route the SCOPED rescan (ISSUE 12
    #: satellite a) patches a changed member through without
    #: reclassifying the whole node bucket
    idx_of_name: dict
    #: per id of ``ids``: True while no status response has been applied
    #: for it — the source of ``full_chunk`` when a patch re-chunks
    unapplied: np.ndarray


def _splice(seq: list, drop: list, at: list, vals: list) -> list:
    """``seq`` without the positions ``drop`` (ascending), with ``vals[k]``
    inserted before old position ``at[k]`` (ascending): list slices
    between the edits, so the Python-level work is O(edits)."""
    out: list = []
    lo = d = k = 0
    while d < len(drop) or k < len(at):
        if k < len(at) and (d == len(drop) or at[k] <= drop[d]):
            out += seq[lo : at[k]]
            out.append(vals[k])
            lo = at[k]
            k += 1
        else:
            out += seq[lo : drop[d]]
            lo = drop[d] + 1
            d += 1
    out += seq[lo:]
    return out


def _full_chunks(unapplied: np.ndarray) -> list:
    """Per ``_BULK_CHUNK`` chunk of an id list: whether it holds an id
    with no status response applied yet (queried at since_version 0)."""
    if not unapplied.size:
        return []
    starts = np.arange(0, unapplied.size, _BULK_CHUNK)
    return np.logical_or.reduceat(unapplied, starts).tolist()


#: gRPC codes meaning "the agent is unreachable / busy", not "the request
#: is bad" — submissions stay Pending and retry on the next sync instead
#: of failing the pod (the reference fails it either way, provider.go:54).
_TRANSIENT_RPC = (
    StatusCode.UNAVAILABLE,
    StatusCode.DEADLINE_EXCEEDED,
    StatusCode.RESOURCE_EXHAUSTED,
    StatusCode.CANCELLED,
)


def _unknown_info(job_id: int) -> JobInfo:
    """The UNKNOWN placeholder row — born frozen like every other row
    that lands in ``pod.status.job_infos`` (the frozen-status fast path
    requires it)."""
    return frozen_new(
        JobInfo,
        id=job_id, user_id="", name="", exit_code="",
        state=JobStatus.UNKNOWN, submit_time=None, start_time=None,
        run_time_s=0, time_limit_s=0, working_dir="", std_out="",
        std_err="", partition="", node_list="", batch_host="",
        num_nodes=0, array_id="", reason="",
    )


def _status_replacement(pod: Pod, infos: list[JobInfo], phase: str) -> Pod:
    """A replacement pod carrying the new job state, structurally sharing
    every frozen sub-object that did not change (spec, labels, …) — the
    zero-deepcopy write the frozen store makes safe. The status is born
    frozen (every info row is), so the commit walk stops at meta."""
    return fast_replace(
        pod,
        meta=fast_replace(pod.meta),
        status=frozen_replace(
            pod.status, job_infos=FrozenList(infos), phase=phase
        ),
    )


#: every JobInfo field EXCEPT the always-ticking runtime counter — derived
#: from the dataclass so a field added later is diffed by construction
#: instead of silently excluded
_INFO_DIFF_FIELDS: tuple[str, ...] = tuple(
    f.name for f in dataclasses.fields(JobInfo) if f.name != "run_time_s"
)

#: ids per JobsInfo request: bounds both the response size (gRPC's default
#: 4 MB message cap — ~50k infos would blow straight through it) and the
#: per-RPC latency a serial agent-side handler can accumulate
_BULK_CHUNK = 2000

#: JobsInfo answers up to this size decode inline rather than in the
#: worker pool: a version field alone (the chunk unchanged since the
#: cursor) is at most 11 bytes
_INLINE_DECODE_BYTES = 16

#: requests per SubmitJobs batch — much smaller than _BULK_CHUNK because
#: each request carries a whole sbatch script (KBs, not an int64): 512 ×
#: an 8 KB script stays safely inside gRPC's 4 MB default message cap
_SUBMIT_CHUNK = 512


def _infos_equivalent(a: list[JobInfo], b: list[JobInfo]) -> bool:
    """Whether two job-info lists say the same thing, ignoring the
    always-ticking ``run_time_s`` counter.

    The diff-driven mirror (PR-3) must not rewrite every RUNNING pod every
    sync just because its elapsed-runtime display advanced; run_time rides
    along whenever a real change (state, nodes, exit code, …) lands.
    """
    if len(a) != len(b):
        return False
    fields = _INFO_DIFF_FIELDS
    for x, y in zip(a, b):
        dx, dy = x.__dict__, y.__dict__
        for name in fields:
            if dx.get(name) != dy.get(name):
                return False
    return True


class VirtualNodeProvider:
    def __init__(
        self,
        store: ObjectStore,
        client: ServiceClient,
        partition: str,
        *,
        agent_endpoint: str = "",
        events: EventRecorder | None = None,
        inventory_ttl: float = 5.0,
        sync_workers: int = 10,
        status_interval: float = 10.0,
        incremental: bool = False,
        use_coldec: bool = True,
        mirror_frames: bool = True,
        inventory_listener=None,
    ):
        self.store = store
        self.client = client
        self.partition = partition
        self.node_name = partition_node_name(partition)
        self.agent_endpoint = agent_endpoint
        self.events = events or EventRecorder()
        self.inventory_ttl = inventory_ttl
        #: max heartbeat age before the node object is rewritten even with
        #: unchanged capacity — between heartbeats an unchanged node costs
        #: ZERO store writes per sync (the reference's kubelet pushes node
        #: status once a MINUTE; writing every 250 ms sync was pure churn)
        self.status_interval = status_interval
        #: whether the agent speaks the batched JobsInfo RPC; flipped off
        #: on the first UNIMPLEMENTED and the mirror falls back to the
        #: per-pod JobInfo loop (old agents keep working, just slower)
        self._bulk_supported = True
        #: same contract for the batched SubmitJobs RPC (PR-4): remembered
        #: per provider, so an old agent costs ONE probe, not one failed
        #: batch per converge
        self._batch_submit_supported = True
        #: pods submitted per path this provider's lifetime — the sim
        #: headline JSON surfaces these so a silent fallback to the slow
        #: per-pod path is visible in diagnostics
        self.submits_batched = 0
        self.submits_fallback = 0
        self._count_lock = threading.Lock()
        #: parallel pod converges per sync tick — the reference's
        #: PodSyncWorkers (DefaultPodSyncWorkers = 10,
        #: cmd/slurm-virtual-kubelet/app/options/options.go:107): each
        #: pod submit is a blocking sbatch exec through the agent, and a
        #: cold-start bind of thousands of pods serialised behind one
        #: thread (measured 63.6 s for 5k pods on one core, round 5)
        self.sync_workers = max(1, sync_workers)
        self._pool = None  # lazily-built, reused across sync ticks
        self._pool_lock = threading.Lock()
        self._pool_closed = False
        self._inv_lock = threading.Lock()
        self._inv: tuple[float, PartitionInfo, list[NodeInfo]] | None = None
        #: content-keyed node decode memo (wire/convert.py): a steady
        #: tick's Nodes response is byte-identical to the last one, so
        #: the per-partition proto decode is skipped
        self._nodes_decode = NodesDecodeCache()
        #: event-driven incremental mirror (PR-11). Off (the default) is
        #: the PR-10 tick byte-for-byte. On, the provider keeps cursors
        #: against BOTH change sources — the store's Pod dirty-set (pod
        #: classification) and the agent's jobs/nodes state versions
        #: (status + inventory) — so a sync tick in which nothing moved
        #: costs the same RPC COUNT as the full tick (fault-injection
        #: parity: each call is one injection draw) but O(changes)
        #: response bytes, decode, diff and store work. Requires the
        #: columnar store + bulk RPCs; anything on a fallback path runs
        #: the full mirror unchanged.
        self.incremental = incremental
        #: the zero-object wire→column decode (ISSUE 14). On, the bulk
        #: RPCs are dialed through their raw-bytes twins (when the client
        #: exposes them — the real ServiceClient and the sim fake do; any
        #: duck-typed test client silently keeps the pb2 path) and
        #: responses decode straight into columns. Off — or after a
        #: remembered per-method fallback (schema drift, malformed
        #: bytes) — the PR-12 pb2 tick runs byte-for-byte.
        self.use_coldec = use_coldec and coldec.available()
        self._coldec_fallback: set[str] = set()
        #: partitioned commit frames (ISSUE 19). On AND a colpool is
        #: active, the bulk-status decode runs the diff+frames op — pool
        #: workers pre-pack the tier-2 string columns for changed rows —
        #: and the status commit merges the per-chunk writer partitions
        #: through ``store.apply_frames``. With no pool (width 0, the
        #: 1-core default) or Off, the PR-18 serial column scatter runs
        #: byte-for-byte; a frame payload failure falls back per chunk
        #: with the pool healthy, and PoolBroken mid-tick completes the
        #: tick on the remembered inline arm.
        self.mirror_frames = mirror_frames
        #: writer-partition id for the store's per-partition dirty-set —
        #: the harness group loop stamps the shard-ownership group index
        #: here; None records into the global per-kind set as before
        self._dirty_partition: int | None = None
        self._part_decode = PartitionDecodeCache()
        #: store-side cursor: Pod rv watermark of the last classification
        self._scan_rv = 0
        self._mirror_cache: _MirrorCache | None = None
        #: the names the last sync submitted: the next one re-examines
        #: them beside the dirty names, since a submit that failed
        #: transiently leaves no store trace and must be retried
        self._resubmit: list[str] = []
        #: one incremental sync at a time: sync() runs concurrently (the
        #: partition ticker and sync_now callers), and the cursor, the kept
        #: working set and the status passes over it move together
        self._sync_lock = threading.RLock()
        #: classification-work accounting (ISSUE 12 satellite a): full
        #: node-bucket reclassifications vs dirty-set-scoped patches and
        #: the changed rows those patches touched — the regression test
        #: pins classification work ∝ changed names, not O(cluster) —
        #: and the live pods the patches added to and took out of the
        #: working set
        self.mirror_scans_full = 0
        self.mirror_scans_scoped = 0
        self.mirror_scoped_rows = 0
        self.mirror_patched_joins = 0
        self.mirror_patched_leaves = 0
        #: agent-side cursors: jobs-state / nodes-state versions last
        #: fully applied (0 = no cursor yet → full responses)
        self._jobs_cursor = 0
        #: job ids a status response has actually been APPLIED for — the
        #: cursor is only trusted for these; anything else queries full
        self._applied_ids: set[int] = set()
        self._nodes_cursor = 0
        self._nodes_cache: list[NodeInfo] | None = None
        self._nodes_req: object | None = None
        self._nodes_req_names: tuple | None = None
        #: serializes the cursor fetch (shared request proto + RPC)
        self._nodes_fetch_lock = threading.Lock()
        #: (nodes list ref) → summed capacity memo for register()
        self._cap_memo: tuple | None = None
        #: ``(partition, nodes) ->`` callback fired when the decoded
        #: inventory CONTENT changes (identity-keyed — the decode caches
        #: replay the same list object while bytes are unchanged, so an
        #: idle shard reports nothing). The scheduler hangs the
        #: streaming-admission window maintenance here (ROADMAP
        #: follow-up c); None costs one attribute check per fetch.
        self._inventory_listener = inventory_listener
        self._inv_reported: object = None

    # ---- inventory / capacity ----

    def inventory(self, *, max_age: float | None = None) -> tuple[PartitionInfo, list[NodeInfo]]:
        """Live (partition, nodes) via Partition + Nodes RPC, cached briefly
        so the capacity advertiser and scheduler share one query per tick
        (the batched-snapshot fix for SURVEY.md §3.2's per-pod exec)."""
        ttl = self.inventory_ttl if max_age is None else max_age
        with self._inv_lock:
            if self._inv is not None and time.monotonic() - self._inv[0] < ttl:
                return self._inv[1], self._inv[2]
        part_resp = self.client.Partition(
            pb.PartitionRequest(partition=self.partition)
        )
        if self.incremental:
            part = self._part_decode.decode(part_resp)
            nodes = self._nodes_incremental(part)
            if nodes is None:
                # degenerate serve-once empty view (see
                # _nodes_incremental): must NOT enter the TTL cache —
                # callers within the window would get zero capacity
                # without even the retry RPC that heals it
                return part, []
        else:
            part = partition_from_proto(part_resp)
            nodes = self._nodes_full(part)
        if (
            self._inventory_listener is not None
            and nodes is not self._inv_reported
        ):
            # report CONTENT changes only (the decode caches are
            # identity-stable on unchanged bytes) — the admission
            # window's idle-cluster maintenance seam
            self._inv_reported = nodes
            try:
                self._inventory_listener(self.partition, nodes)
            except Exception:
                log.exception(
                    "inventory listener failed for %s", self.partition
                )
        with self._inv_lock:
            self._inv = (time.monotonic(), part, nodes)
        return part, nodes

    def _nodes_full(self, part: PartitionInfo) -> list[NodeInfo]:
        """The full (non-cursor) Nodes fetch: one RPC, decoded through
        the coldec bytes path when available — the content-keyed memo now
        keys on the raw buffer itself, so the steady-state skip costs one
        bytes compare instead of a deterministic re-serialization."""
        req = pb.NodesRequest(names=list(part.nodes))
        bytes_fn = self._bytes_rpc("Nodes")
        if bytes_fn is None:
            return self._nodes_decode.decode(self.client.Nodes(req))
        raw = bytes_fn(req)
        try:
            dec = self._nodes_decode.decode_bytes(raw)
        except coldec.DecodeError as e:
            self._coldec_fall_back("Nodes", str(e))
            return self._nodes_decode.decode(pb.NodesResponse.FromString(raw))
        return dec.nodes

    def _nodes_incremental(self, part: PartitionInfo) -> list[NodeInfo] | None:
        """The cursor-bearing Nodes fetch (PR-11): one RPC either way —
        same injection-draw count as the full path — but when the agent's
        nodes-state version matches the cursor the response carries zero
        rows and the previously-decoded list (identity-stable, so every
        downstream memo holds) is replayed.

        Held under ``_nodes_fetch_lock`` for the whole stamp+RPC: the
        cached request proto is shared across ticks, and a concurrent
        ``inventory()`` caller restamping ``since_version`` while gRPC
        serializes it would race (the full path builds a fresh request
        per call and has no such hazard). Fetches serialize; the TTL
        window keeps that off the common path."""
        with self._nodes_fetch_lock:
            if self._nodes_req is None or self._nodes_req_names != part.nodes:
                # first fetch or membership change: a cursor is only
                # valid against the exact name set its response answered
                self._nodes_req = pb.NodesRequest(names=list(part.nodes))
                self._nodes_req_names = part.nodes
                self._nodes_cursor = 0
                self._nodes_cache = None
            req = self._nodes_req
            req.since_version = (
                self._nodes_cursor if self._nodes_cache is not None else 0
            )
            bytes_fn = self._bytes_rpc("Nodes")
            if bytes_fn is not None:
                raw = bytes_fn(req)
                try:
                    dec = self._nodes_decode.decode_bytes(raw)
                except coldec.DecodeError as e:
                    self._coldec_fall_back("Nodes", str(e))
                    dec = None
                if dec is not None:
                    if dec.unchanged:
                        if self._nodes_cache is not None:
                            return self._nodes_cache
                        # same degenerate posture as the pb2 branch below
                        return None
                    self._nodes_cache = dec.nodes
                    self._nodes_cursor = dec.version
                    return dec.nodes
                resp = pb.NodesResponse.FromString(raw)
            else:
                resp = self.client.Nodes(req)
            if resp.unchanged:
                if self._nodes_cache is not None:
                    return self._nodes_cache
                # degenerate: an "unchanged" answer with no local cache
                # (a frozen stale_snapshot window replaying across a
                # provider rebuild). Adopting the empty row set as the
                # inventory — and worse, CACHING it against the frozen
                # version — would zero this partition's capacity for
                # good. None = serve an empty view once, cache nothing
                # (cursor, decode cache AND the caller's TTL slot),
                # advance nothing: the next fetch retries at since=0 and
                # heals the moment a real response arrives.
                return None
            nodes = self._nodes_decode.decode(resp)
            self._nodes_cache = nodes
            self._nodes_cursor = int(resp.version)
            return nodes

    # ---- the zero-object decode seams (ISSUE 14) ----

    def _bytes_rpc(self, method: str):
        """The raw-bytes callable for a bulk method, or None when the
        coldec path is off, remembered-fallen-back, or the client does
        not expose the bytes twin (duck-typed fakes, FaultyClient —
        which masks it so fault draws stay on the pb2 sequence)."""
        if not self.use_coldec or method in self._coldec_fallback:
            return None
        return getattr(self.client, _BYTES_RPCS[method], None)

    def _coldec_fall_back(self, method: str, why: str) -> None:
        """Remember a per-method pb2 fallback (same pattern as the
        bulk-submit UNIMPLEMENTED memory)."""
        self._coldec_fallback.add(method)
        coldec.fallback_counter().inc(method=method)
        log.warning(
            "coldec %s decode fell back to the pb2 path: %s", method, why
        )

    def _bulk_status_bytes(self, bytes_fn, reqs: list) -> tuple[str, object, list]:
        """Issue the chunked JobsInfo round-trips through the bytes path,
        decoding each response into columns INSIDE the pool worker that
        fetched it (the NumPy kernels run while other chunks are still
        on the wire). Returns ``(state, scratch, versions)``:

        - ``("ok", scratch, versions)`` — every chunk fetched+decoded;
        - ``("unimplemented", None, [])`` — agent lacks JobsInfo (caller
          flips the provider, exactly the pb2 path's handling);
        - ``("abort", None, [])`` — transient RPC failure: apply nothing,
          keep cursors (the level-triggered retry heals next sync);
        - ``("fallback", None, [])`` — malformed bytes: the method is
          remembered onto the pb2 path and the caller re-queries there.

        Chunk results merge in REQUEST order regardless of completion
        order, so the scratch's row layout — and everything downstream —
        is deterministic.

        When the process worker pool (``parallel/colpool``) is active
        and there is more than one chunk, the fetch threads capture raw
        buffers only and the decode fans out across worker processes —
        same per-chunk results, off the parent's interpreter."""
        results: list = [None] * len(reqs)
        pool = colpool.active_pool() if len(reqs) > 1 else None

        def fetch(i: int) -> None:
            try:
                raw = bytes_fn(reqs[i])
            except RpcError as e:
                results[i] = ("rpc", e)
                return
            if pool is not None and len(raw) > _INLINE_DECODE_BYTES:
                # an answer with no entry (the chunk unchanged since the
                # cursor) decodes here: cheaper than the pool round trips
                results[i] = ("raw", raw)
                return
            try:
                results[i] = ("ok", coldec.decode_jobs_info(raw))
            except coldec.DecodeError as e:
                results[i] = ("dec", e)

        if len(reqs) > 1:
            self._pool_map(fetch, list(range(len(reqs))))
        elif reqs:
            fetch(0)
        frames_map: dict[int, object] = {}
        if pool is not None:
            raw_idx = [
                i for i, r in enumerate(results) if r is not None
                and r[0] == "raw"
            ]
            if raw_idx:
                raws = [results[i][1] for i in raw_idx]
                decoded = None
                if self.mirror_frames:
                    # diff+frames op: the workers that decode also pack
                    # the commit frame for their chunk's changed rows.
                    # None = pool couldn't serve (broken mid-tick,
                    # remembered) — decode_jobs_info_many below then
                    # runs the inline serial arm and the tick completes
                    # frameless.
                    framed = pool.decode_diff_frames_many(
                        raws, colpool.empty_prior()
                    )
                    if framed is not None:
                        decoded = []
                        for j, d in enumerate(framed):
                            if isinstance(d, coldec.DecodeError):
                                decoded.append(d)
                                continue
                            chunk, fbytes = d
                            if fbytes:
                                try:
                                    frames_map[raw_idx[j]] = (
                                        colstore.CommitFrame(fbytes)
                                    )
                                except colstore.FrameError:
                                    pass  # frameless chunk: spans serve
                            decoded.append(chunk)
                if decoded is None:
                    decoded = pool.decode_jobs_info_many(raws)
                for i, dec in zip(raw_idx, decoded):
                    if isinstance(dec, coldec.DecodeError):
                        results[i] = ("dec", dec)
                    else:
                        results[i] = ("ok", dec)
        for kind, payload in results:
            if kind == "rpc":
                if payload.code() == StatusCode.UNIMPLEMENTED:
                    self._bulk_supported = False
                    _bulk_fallbacks.inc()
                    log.warning(
                        "agent does not implement JobsInfo; "
                        "falling back to per-pod status queries"
                    )
                    return "unimplemented", None, []
                log.warning("bulk status query failed: %s", payload.details())
                return "abort", None, []
            if kind == "dec":
                self._coldec_fall_back("JobsInfo", str(payload))
                return "fallback", None, []
        scratch = ColdecScratch()
        versions: list[int] = []
        rows = 0
        for _, chunk in results:
            _bulk_queries.inc()
            scratch.add_chunk(chunk)
            versions.append(chunk.version)
            rows += chunk.rows
        # chunk index in the scratch == position in results (request
        # order), which is how frames_map was keyed above
        scratch.frames = frames_map or None
        coldec.rows_counter().inc(rows)
        return "ok", scratch, versions

    def _bulk_status_pb2(self, reqs: list, names: list):
        """The pb2 chunk loop shared by the full and cursor status paths
        — and the re-query target when a coldec decode falls back.
        Returns ``(scratch, versions)``; ``(None, None)`` means the
        error was handled (UNIMPLEMENTED flipped the provider and
        converged per pod; a transient failure applied nothing) and the
        caller just returns."""
        scratch = InfoScratch()
        versions: list[int] = []
        for req in reqs:
            try:
                resp = self.client.JobsInfo(req)
            except RpcError as e:
                if e.code() == StatusCode.UNIMPLEMENTED:
                    self._bulk_supported = False
                    _bulk_fallbacks.inc()
                    log.warning(
                        "agent does not implement JobsInfo; "
                        "falling back to per-pod status queries"
                    )
                    self._converge_names(names)
                    return None, None
                # transient: apply NOTHING and keep cursors — the next
                # successful pass re-delivers everything missed (the
                # level-triggered keep-current-statuses posture)
                log.warning("bulk status query failed: %s", e.details())
                return None, None
            _bulk_queries.inc()
            versions.append(int(resp.version))
            for entry in resp.jobs:
                jid = int(entry.job_id)
                if not entry.found or not len(entry.info):
                    scratch.add_unknown(jid)
                    continue
                for m in entry.info:
                    scratch.add_proto(jid, m)
        return scratch, versions

    def capacity(self) -> tuple[dict[str, float], dict[str, float]]:
        """(capacity, allocatable) summed over member nodes
        (GetPartitionCapacity node.go:169-199)."""
        _, nodes = self.inventory()
        if self.incremental:
            memo = self._cap_memo
            if memo is not None and memo[0] is nodes:
                # identity-stable node list (the cursor hit): the summed
                # capacity is definitionally unchanged
                return memo[1], memo[2]
        cap = {"cpu": 0.0, "memory_mb": 0.0, "gpu": 0.0, "pods": 0.0}
        free = {"cpu": 0.0, "memory_mb": 0.0, "gpu": 0.0, "pods": 0.0}
        for n in nodes:
            cap["cpu"] += n.cpus
            cap["memory_mb"] += n.memory_mb
            cap["gpu"] += n.gpus
            free["cpu"] += n.free_cpus
            free["memory_mb"] += n.free_memory_mb
            free["gpu"] += n.free_gpus
        # reference: pods capacity = cpu count (node.go:197)
        cap["pods"] = cap["cpu"]
        free["pods"] = free["cpu"]
        if self.incremental:
            self._cap_memo = (nodes, cap, free)
        return cap, free

    def pod_stats(self) -> list[tuple[Pod, dict]]:
        """Per-pod stats rows for the kubelet /stats/summary endpoint —
        the surface the reference declares but ships commented out
        (provider.go:324-392)."""
        out = []
        for pod in self.store.list_by_node(Pod.KIND, self.node_name):
            dem = pod.spec.demand
            arr = array_len(dem.array) if dem else 1
            info = {
                "state": pod.status.phase,
                "job_ids": list(pod.status.job_ids),
                "cpus": float(dem.total_cpus(arr)) if dem else 0.0,
                "start_time": next(
                    (str(i.start_time) for i in pod.status.job_infos if i.start_time),
                    "",
                ),
            }
            out.append((pod, info))
        return out

    def register(self) -> VirtualNode:
        """Create or refresh the VirtualNode object (the NodeController's
        create-on-404 handler, virtual-kubelet.go:281-292)."""
        cap, free = self.capacity()
        existing = self.store.try_get(VirtualNode.KIND, self.node_name)
        if existing is None:
            node = VirtualNode(
                meta=Meta(
                    name=self.node_name,
                    labels={"type": "virtual-kubelet", "partition": self.partition},
                ),
                partition=self.partition,
                capacity=cap,
                allocatable=free,
                conditions=[NodeCondition(type="Ready", status=True)],
                heartbeat=time.time(),
                agent_endpoint=self.agent_endpoint,
            )
            try:
                node = self.store.create(node, site="vnode.node")
            except AlreadyExists:
                # create-on-404 must tolerate losing the race: sync() runs
                # concurrently (ticker + sync_now callers) and two threads
                # can both observe the node missing — fall through to the
                # refresh path the winner's node now serves
                pass
            else:
                self.events.event(
                    node, Reason.NODE_READY, f"partition {self.partition} ready"
                )
                return node
        elif (
            existing.ready
            and existing.capacity == cap
            and existing.allocatable == free
            and time.time() - existing.heartbeat < self.status_interval
        ):
            # steady state: same capacity, fresh heartbeat — zero writes
            # (a node write per sync tick was one-third of the mirror churn)
            return existing

        def refresh(node: VirtualNode):
            node.capacity = cap
            node.allocatable = free
            node.heartbeat = time.time()
            node.conditions = [NodeCondition(type="Ready", status=True)]

        return self.store.mutate(
            VirtualNode.KIND, self.node_name, refresh, site="vnode.node"
        )

    def close(self) -> None:
        """Shut the pod-sync pool WITHOUT deleting the store node.

        This is the clean-shutdown half of the old ``deregister()``
        (ADVICE r5 #1): Configurator.stop() — every Bridge.stop(), leader
        step-down, embedder cycle — must stop the non-daemon worker
        threads, but deleting the VirtualNode there made node objects
        flap across restarts (the NodePodMirror propagates the deletion
        to the real apiserver). Only partition removal deletes the node.
        """
        with self._pool_lock:
            pool, self._pool = self._pool, None
            self._pool_closed = True
        if pool is not None:
            # no cancel_futures: a sync in flight finishes converging its
            # pods; the workers exit once the queue drains
            pool.shutdown(wait=False)

    def deregister(self) -> None:
        """Tear down for real: close the pool AND delete the store node
        (the partition vanished — _remove_partition's path)."""
        self.close()
        try:
            self.store.delete(VirtualNode.KIND, self.node_name)
        except NotFound:
            pass

    # ---- pod lifecycle ----

    def sync(self) -> None:
        """One provider tick: refresh the node, converge pods that need a
        per-pod action (submit / terminate), then mirror live job state
        into the rest with ONE batched JobsInfo query and diff-only writes.

        This is the PR-3 mirror rework. The old tick listed (and deep-
        copied) the WHOLE store per provider and paid one JobInfo RPC per
        pod; now the ``(kind, node_name)`` index hands each provider
        exactly its pods, terminal pods cost nothing, and an unchanged pod
        costs zero store writes and no per-pod RPC.
        """
        with TRACER.span("vnode.sync", partition=self.partition) as span:
            t0 = time.perf_counter()
            self.register()
            table = self.store.table(Pod.KIND)
            if (
                table is not None
                and self._batch_submit_supported
                and self._bulk_supported
            ):
                # the columnar mirror: classification, batched submit and
                # the status diff all run on columns — frozen views are
                # built only for the odd pods (deletions, conflicts,
                # multi-job) that need the per-object oracle
                if self.incremental:
                    with self._sync_lock:
                        self._sync_cols(table, span, t0)
                else:
                    self._sync_cols(table, span, t0)
                return
            work: list[Pod] = []  # needs per-pod converge (submit/terminate)
            refresh: list[Pod] = []  # has live jobs: bulk status mirror
            for p in self.store.list_by_node(Pod.KIND, self.node_name):
                if p.meta.deleted:
                    work.append(p)
                elif p.spec.role != PodRole.SIZECAR:
                    continue
                elif not p.status.job_ids:
                    work.append(p)
                elif p.status.phase not in PodPhase.TERMINAL:
                    refresh.append(p)
                # terminal phase with job_ids: nothing left to learn — a
                # dead pod must not cost one RPC per sync tick forever
            span.count("converge_pods", len(work))
            span.count("refresh_pods", len(refresh))
            self._converge(work)
            t1 = time.perf_counter()
            self._refresh_statuses(refresh)
            t2 = time.perf_counter()
            _status_seconds.observe(t2 - t1)
            _sync_seconds.observe(t2 - t0)

    def sync_staged(self):
        """One provider tick split at the status fetch: returns
        ``(fetch, apply)`` callables, or None when this tick cannot be
        staged (object-store path, a remembered batch/bulk fallback, or
        no bytes twin — FaultyClient masks it, so fault-bearing runs
        always take the plain path and their draw sequences hold).

        The contract the pipelined mirror (sim/harness.py) builds on:

        - calling ``sync_staged`` runs register + classification +
          converge/submit INLINE (all store writes, caller's thread);
        - ``fetch()`` issues only the chunked JobsInfo round-trips —
          no store access — and is safe on a background thread while
          the NEXT provider's prepare runs;
        - ``apply(fetch_result)`` diffs and writes on the caller's
          thread.

        Prepare → fetch → apply in that order is exactly ``sync()``
        decomposed, so serial callers of the staged form are
        byte-identical to the plain form."""
        table = self.store.table(Pod.KIND)
        if (
            table is None
            or not self._batch_submit_supported
            or not self._bulk_supported
            or self._bytes_rpc("JobsInfo") is None
        ):
            return None
        with TRACER.span("vnode.sync", partition=self.partition) as span:
            t0 = time.perf_counter()
            self.register()
            mode, payload = self._sync_cols_prepare(table, span, t0)
        if (
            mode == "done"
            or (mode == "incr" and not payload.rb.names)
            or (mode == "full" and not payload.names)
        ):
            return (lambda: None), (lambda fetched: None)
        bytes_fn = self._bytes_rpc("JobsInfo")
        if bytes_fn is None:  # pragma: no cover - cannot flip mid-prepare
            t1 = time.perf_counter()
            if mode == "incr":
                self._refresh_statuses_cols_incr(table, payload)
            else:
                self._refresh_statuses_cols(table, payload)
            t2 = time.perf_counter()
            _status_seconds.observe(t2 - t1)
            _sync_seconds.observe(t2 - t0)
            return (lambda: None), (lambda fetched: None)
        if mode == "incr":
            mc = payload
            self._prep_status_incr(mc)

            def fetch():
                return self._bulk_status_bytes(bytes_fn, mc.reqs)

            def apply(fetched) -> None:
                t1 = time.perf_counter()
                with TRACER.span("vnode.status") as span2:
                    span2.count("pods", len(mc.rb.names))
                    self._apply_status_incr(table, mc, span2, fetched)
                t2 = time.perf_counter()
                _status_seconds.observe(t2 - t1)
                _sync_seconds.observe(t2 - t0)

            return fetch, apply
        rb = payload
        ids, reqs = self._status_reqs_full(rb)

        def fetch():
            return self._bulk_status_bytes(bytes_fn, reqs)

        def apply(fetched) -> None:
            t1 = time.perf_counter()
            with TRACER.span("vnode.status") as span2:
                span2.count("pods", len(rb.names))
                self._apply_status_full(table, rb, span2, ids, reqs, fetched)
            t2 = time.perf_counter()
            _status_seconds.observe(t2 - t1)
            _sync_seconds.observe(t2 - t0)

        return fetch, apply

    # ---- the columnar mirror (PR-6) ----

    def _sync_cols(self, table, span, t0: float) -> None:
        """One provider tick on columns: vectorized classification, the
        batched submit fed straight from spec columns, and the status
        mirror as one vectorized column compare (45k Python object diffs
        become one ``!=`` reduction per field).

        Incremental mode (PR-11) consults the store's Pod dirty-set
        first: when no pod has been written since the last
        classification, the whole rows_by_node scan + mask
        classification is skipped and the cached working set drives a
        cursor-bearing status pass — an idle shard's mirror is a probe
        plus one cheap RPC per id-chunk and zero decode/diff work."""
        mode, payload = self._sync_cols_prepare(table, span, t0)
        if mode == "done":
            return
        t1 = time.perf_counter()
        if mode == "incr":
            self._refresh_statuses_cols_incr(table, payload)
        else:
            self._refresh_statuses_cols(table, payload)
        t2 = time.perf_counter()
        _status_seconds.observe(t2 - t1)
        _sync_seconds.observe(t2 - t0)

    def _sync_cols_prepare(self, table, span, t0: float):
        """Everything in a columnar tick BEFORE the status fetch:
        classification (full, patched, or skipped via the dirty-set),
        deletions, and the batched submits. Returns ``(mode, payload)``
        where mode is ``"incr"`` (payload: the mirror cache to cursor-
        sync), ``"full"`` (payload: the refresh batch for the full
        status pass) or ``"done"`` (nothing to refresh). The staged
        mirror (``sync_staged``) cuts here so the fetch half can overlap
        the NEXT provider's prepare — the plain path calls this then
        refreshes inline, byte-identically."""
        mc = None
        with TRACER.span("vnode.classify"):
            if not self.incremental:
                items, work_names, refresh = self._classify_full(table)
            else:
                with self._sync_lock:
                    items, work_names, refresh, mc = self._classify_incr(
                        table, span
                    )
                    # a terminate that failed transiently leaves no store
                    # trace either: the full classification retries it
                    self._mirror_cache = mc if not work_names else None
                    self._resubmit = [it.name for it in items]
        if refresh is None:
            span.count("converge_pods", 0)
            span.count("refresh_pods", 0)
            now = time.perf_counter()
            _status_seconds.observe(0.0)
            _sync_seconds.observe(now - t0)
            return "done", None
        span.count("converge_pods", len(items) + len(work_names))
        span.count("refresh_pods", len(refresh.names))
        # deletions first: a terminate frees capacity the submits may need
        if work_names:
            pods = [
                p
                for n in work_names
                if (p := self.store.try_get(Pod.KIND, n)) is not None
            ]
            self._pool_map(self._sync_pod_safe, pods)
        if items:
            chunks = [
                items[lo : lo + _SUBMIT_CHUNK]
                for lo in range(0, len(items), _SUBMIT_CHUNK)
            ]
            pre = self._precode_submit_chunks(chunks)
            self._pool_map(
                self._submit_chunk_cols_safe, list(zip(chunks, pre))
            )
        if self.incremental:
            return "incr", mc
        return "full", refresh

    def _classify_incr(self, table, span):
        """The incremental classification: ``(items, work_names,
        refresh, mirror cache)``. Consults the store's Pod dirty-set
        first: with nothing written and nothing to resubmit, the kept
        working set drives the cursor sync as it is; otherwise it is
        patched for the written names, and only what the patch refuses
        reclassifies the node bucket."""
        rv, changed, deleted = self.store.changes_since(
            Pod.KIND, self._scan_rv
        )
        mc = self._mirror_cache
        if mc is not None:
            if not changed and not deleted and not self._resubmit:
                return [], [], mc.rb, mc
            patched = self._rescope_mirror_cache(
                table, mc, changed, deleted, span
            )
            if patched is not None:
                self._scan_rv = rv
                mc, items = patched
                return items, [], mc.rb, mc
        self._scan_rv = rv
        self.mirror_scans_full += 1
        span.set_tag("scan", "full")
        items, work_names, refresh = self._classify_full(table)
        if refresh is None:
            return items, work_names, None, None
        mc = self._build_mirror_cache(refresh)
        # ids that left the working set stop counting as applied
        self._applied_ids.intersection_update(mc.ids.tolist())
        return items, work_names, refresh, mc

    @staticmethod
    def _submit_item(c, name: str, row: int) -> _SubmitItem:
        ann = c.ann[row]
        return _SubmitItem(
            name, c.demand[row], c.uid[row],
            ann.get("submit-generation", ""), c.hint[row],
            int(c.rv[row]), c.labels[row], ann,
        )

    def _classify_full(self, table):
        """One pass over the provider's whole node bucket: ``(submit
        items, deletion names, refresh batch)``, each in name order; the
        refresh batch is None when the bucket is empty."""
        c = table.cols
        with self.store.locked():
            # names→rows resolved under the SAME lock hold as the column
            # reads: a delete+create between the two would recycle a row
            # index and pair a name with another pod's columns
            names, rows = self.store.rows_by_node(Pod.KIND, self.node_name)
            if not names:
                return [], [], None
            deleted = c.deleted[rows]
            sizecar = c.role[rows] == PodRole.SIZECAR
            njobs = c.njobs[rows]
            phase = c.phase[rows]
            rv = c.rv[rows]
            live = (
                sizecar
                & ~deleted
                & (njobs > 0)
                & (phase != _PH_SUCCEEDED)
                & (phase != _PH_FAILED)
            )
            submit_mask = sizecar & ~deleted & (njobs == 0)
            items = [
                self._submit_item(c, names[i], int(rows[i]))
                for i in np.nonzero(submit_mask)[0].tolist()
            ]
            ri = np.nonzero(live)[0]
            rrows = rows[ri]
            refresh = _RefreshBatch(
                names=[names[i] for i in ri.tolist()],
                job_ids=[c.job_ids[int(r)] for r in rrows.tolist()],
                rv=rv[ri],
                phase=phase[ri],
                ilen=c.ilen[rrows],
            )
            work_names = [names[i] for i in np.nonzero(deleted)[0].tolist()]
        return items, work_names, refresh

    def _rescope_mirror_cache(
        self, table, mc: _MirrorCache, changed, deleted, span
    ):
        """Scoped mirror rescan (ISSUE 12 satellite a): after a pod
        write, patch the working set for the CHANGED names only instead
        of one full node-bucket reclassification per provider.

        The names the last sync submitted are re-examined too: a submit
        that failed transiently leaves no store trace. Returns ``(mirror
        cache, submit items)``, or None when the full classification
        must run.

        Handled here, each the way the full classification would see it:
        writes to pods on OTHER nodes (ignored), worker pods here
        (ignored), a live member's rv/phase/status-row moves (patched in
        place), a submit-eligible pod here (a submit item), a live pod
        new to the set (a join: inserted at its name-sorted place, its
        ids appended to the id list — mostly the pods this provider
        submitted last sync), a member turned SUCCEEDED or FAILED (a
        leave: taken out with the ids no other member holds). A deletion
        here, a member moving off the node and a member's job ids moving
        return None. The work is O(changed names + joins + leaves) in
        Python; what is O(members) is list slicing and array work.
        """
        idx_of = mc.idx_of_name
        if not idx_of.keys().isdisjoint(deleted):
            return None  # tombstoned member: membership change
        # the last sync's submits, unless written since (``changed`` is
        # name-sorted)
        probe = changed + [
            n for n in self._resubmit
            if (k := bisect.bisect_left(changed, n)) == len(changed)
            or changed[k] != n
        ]
        rb = mc.rb
        items: list[tuple[str, int]] = []
        joins: list[tuple[str, int]] = []
        leaves: list[int] = []
        moved: list[int] = []  # batch indices of in-place patches
        moved_rows: list[int] = []
        with self.store.locked():
            c = table.cols
            rows = table.rows_for(probe)
            found = rows >= 0
            here = found & (c.node[np.where(found, rows, 0)] == self.node_name)
            away = np.asarray(probe, dtype=object)[~here]
            if not idx_of.keys().isdisjoint(away):
                return None  # a member moved off this node
            hk = np.flatnonzero(here)
            hrows = rows[hk]
            if c.deleted[hrows].any():
                return None  # deletion work: converge/classify
            sizecar = (c.role[hrows] == PodRole.SIZECAR).tolist()
            njobs = c.njobs[hrows].tolist()
            ph = c.phase[hrows]
            terminal = ((ph == _PH_SUCCEEDED) | (ph == _PH_FAILED)).tolist()
            hrows_l = hrows.tolist()
            for k, x in enumerate(hk.tolist()):
                name, row = probe[x], hrows_l[k]
                i = idx_of.get(name)
                if i is None:
                    if not sizecar[k]:
                        # a worker pod here: never submitted, mirrored or
                        # deleted by this provider, so the full
                        # classification would not see it either
                        continue
                    if njobs[k] == 0:
                        items.append((name, row))
                    elif not terminal[k]:
                        joins.append((name, row))
                    continue
                if (
                    not sizecar[k]
                    or njobs[k] == 0
                    or c.job_ids[row] != rb.job_ids[i]
                ):
                    return None  # ids moved
                if terminal[k]:
                    leaves.append(i)
                else:
                    moved.append(i)
                    moved_rows.append(row)
            if moved:
                rb.rv[moved] = c.rv[moved_rows]
                rb.phase[moved] = c.phase[moved_rows]
                rb.ilen[moved] = c.ilen[moved_rows]
            items.sort()
            submit = [self._submit_item(c, n, r) for n, r in items]
            if joins or leaves:
                mc = self._patch_members(c, mc, joins, leaves)
        self.mirror_scans_scoped += 1
        self.mirror_scoped_rows += len(moved)
        self.mirror_patched_joins += len(joins)
        self.mirror_patched_leaves += len(leaves)
        span.set_tag("scan", "patched")
        span.count("joins", len(joins))
        span.count("leaves", len(leaves))
        return mc, submit

    def _patch_members(
        self, c, mc: _MirrorCache, joins: list, leaves: list
    ) -> _MirrorCache:
        """A new working set from ``mc`` with the ``joins`` (``(name,
        row)``) inserted and the members at ``leaves`` taken out — what
        the full classification would build, id set and chunk count
        included. Call with the store lock held."""
        rb = mc.rb
        joins.sort()
        leaves.sort()
        jnames = [n for n, _ in joins]
        jrows = np.asarray([r for _, r in joins], np.int64)
        jids = [c.job_ids[r] for r in jrows.tolist()]
        at = [bisect.bisect_left(rb.names, n) for n in jnames]
        drop = np.asarray(leaves, np.intp)
        pos = np.asarray(at, np.intp) - np.searchsorted(drop, at)

        def arr(a, col):
            return np.insert(np.delete(a, drop), pos, col[jrows])

        names = _splice(rb.names, leaves, at, jnames)
        new_rb = _RefreshBatch(
            names=names,
            job_ids=_splice(rb.job_ids, leaves, at, jids),
            rv=arr(rb.rv, c.rv),
            phase=arr(rb.phase, c.phase),
            ilen=arr(rb.ilen, c.ilen),
        )
        # the id list: a leave's ids go when no other member holds them,
        # a join's new ids are appended (never applied: full chunks). The
        # routes are copied, not edited: a concurrent sync may still be
        # applying a status pass over ``mc``
        names_of = dict(mc.names_of_jid)
        gone: list[int] = []
        for i in leaves:
            name = rb.names[i]
            for jid in rb.job_ids[i]:
                held = names_of.pop(jid)
                if held != (name,):
                    rest = tuple(n for n in held if n != name)
                    if rest:
                        names_of[jid] = rest
                        continue
                gone.append(jid)
        added: list[int] = []
        for name, jt in zip(jnames, jids):
            for jid in jt:
                held = names_of.get(jid)
                if held is None:
                    names_of[jid] = (name,)
                    added.append(jid)
                else:
                    names_of[jid] = held + (name,)
        applied = self._applied_ids
        applied.difference_update(gone)
        ids, unapplied, reqs = mc.ids, mc.unapplied, mc.reqs
        first = ids.size
        if gone:
            g = np.sort(np.asarray(gone, np.int64))
            keep = g[np.minimum(np.searchsorted(g, ids), g.size - 1)] != ids
            first = int(np.argmin(keep))
            ids, unapplied = ids[keep], unapplied[keep]
        if added:
            ids = np.concatenate([ids, np.asarray(added, np.int64)])
            unapplied = np.concatenate([
                unapplied,
                np.fromiter((j not in applied for j in added), bool, len(added)),
            ])
        if gone or added:
            # the chunks before the first edit hold the same ids
            k0 = first // _BULK_CHUNK
            reqs = reqs[:k0] + [
                pb.JobsInfoRequest(job_ids=ids[lo : lo + _BULK_CHUNK].tolist())
                for lo in range(k0 * _BULK_CHUNK, ids.size, _BULK_CHUNK)
            ]
        return _MirrorCache(
            new_rb, ids, reqs, names_of, _full_chunks(unapplied),
            dict(zip(names, range(len(names)))), unapplied,
        )

    def _build_mirror_cache(self, rb: _RefreshBatch) -> _MirrorCache:
        """Derive the cursor sync's cross-tick state from one
        classification: unique job ids — already-applied ids first, ids
        this provider has never applied a response for appended last —
        pre-built chunk requests (chunk COUNT equals the full path's for
        the same working set, which is what keeps fault-injection draw
        sequences identical between modes), and the jid → member names
        route."""
        applied = self._applied_ids
        old_ids: list[int] = []
        new_ids: list[int] = []
        names_of: dict[int, tuple] = {}
        for name, jt in zip(rb.names, rb.job_ids):
            for jid in jt:
                prev = names_of.get(jid)
                if prev is None:
                    names_of[jid] = (name,)
                    (old_ids if jid in applied else new_ids).append(jid)
                else:
                    names_of[jid] = prev + (name,)
        ids = old_ids + new_ids
        reqs = [
            pb.JobsInfoRequest(job_ids=ids[lo : lo + _BULK_CHUNK])
            for lo in range(0, len(ids), _BULK_CHUNK)
        ]
        unapplied = np.zeros(len(ids), bool)
        unapplied[len(old_ids) :] = True
        idx_of_name = {name: i for i, name in enumerate(rb.names)}
        return _MirrorCache(
            rb, np.asarray(ids, np.int64), reqs, names_of,
            _full_chunks(unapplied), idx_of_name, unapplied,
        )

    def _fail_pod_name(self, name: str, reason: str) -> None:
        def record(p: Pod):
            p.status.phase = PodPhase.FAILED
            p.status.reason = reason

        self.store.mutate(Pod.KIND, name, record, site="vnode.fail")

    def _sync_pod_by_name(self, name: str) -> None:
        pod = self.store.try_get(Pod.KIND, name)
        if pod is not None:
            self._sync_pod_safe(pod)

    @staticmethod
    def _submit_rows(items: list[_SubmitItem]) -> list[tuple]:
        """The effective wire rows for a submit chunk — the converge
        pass's filter + submitter + nodelist-hint logic as a PURE
        function (no pod failing, no events), shared by the worker-pool
        pre-encode and kept in lockstep with :meth:`_submit_chunk_cols`
        by the row-count cross-check there."""
        rows: list[tuple] = []
        for it in items:
            demand = it.demand
            if demand is None or not demand.script.strip():
                continue
            submitter = it.uid if not it.gen else f"{it.uid}#g{it.gen}"
            if it.hint and not demand.nodelist:
                demand = fast_replace(demand, nodelist=it.hint)
            rows.append((demand, submitter))
        return rows

    def _precode_submit_chunks(self, chunks: list) -> list:
        """Pool-encoded ``SubmitJobsRequest`` bytes per chunk: a list
        parallel to ``chunks`` of ``(row count, wire bytes)`` — or
        ``None`` entries when the chunk must encode inline (no bytes
        RPC, no pool, pool broken, payload failure). Runs on the
        prepare side, so under the staged mirror the pool encode for
        provider i+1 overlaps provider i's fetch/apply."""
        none: list = [None] * len(chunks)
        if self._bytes_rpc("SubmitJobs") is None:
            return none
        pool = colpool.active_pool()
        if pool is None:
            return none
        with TRACER.span("vnode.submit_chunk.encode") as span:
            rows_per_chunk = [self._submit_rows(c) for c in chunks]
            frames = [
                writeops.pack_submit_frame(rows) for rows in rows_per_chunk
            ]
            encoded = pool.encode_submit_many(frames)
            span.count("chunks", len(chunks))
            span.count("pods", sum(len(r) for r in rows_per_chunk))
            if encoded is None:
                return none
            _submit_pool_chunks.inc(len(chunks))
            return [
                (len(rows), raw)
                for rows, raw in zip(rows_per_chunk, encoded)
            ]

    def _submit_chunk_cols_safe(self, chunk) -> None:
        items, pre = (
            chunk if isinstance(chunk, tuple) else (chunk, None)
        )
        try:
            self._submit_chunk_cols(items, pre)
        except Exception:
            log.exception("batch submit of %d pods failed", len(items))

    def _submit_chunk_cols(
        self, items: list[_SubmitItem], pre: tuple | None = None
    ) -> None:
        """The batched submit, fed from columns: requests are written in
        place into ONE ``SubmitJobsRequest`` (no per-entry message copy),
        accepted job ids land as one row-commit — the per-item semantics
        (transient stays Pending, rejection fails the pod, UNIMPLEMENTED
        flips the provider) are exactly the object path's.

        ``pre`` is the chunk's worker-pool pre-encode, ``(row count,
        SubmitJobsRequest wire bytes)`` — byte-identical to what the
        inline encode below would serialize (fuzz-pinned), used only
        when its row count matches this pass's converge filter (the two
        run the same ``_submit_rows`` logic; the cross-check turns any
        future drift into a silent inline re-encode, never a wrong
        submit). The converge side effects — failing script-less pods —
        always run HERE, pooled or not."""
        with TRACER.span("vnode.submit_chunk") as span:
            span.count("pods", len(items))
            sent: list[_SubmitItem] = []
            for it in items:
                demand = it.demand
                if demand is None or not demand.script.strip():
                    try:
                        self._fail_pod_name(it.name, "sizecar pod has no script")
                    except NotFound:
                        pass
                    continue
                sent.append(it)
            if not sent:
                return
            bytes_fn = self._bytes_rpc("SubmitJobs")
            raw_req: bytes | None = None
            breq = None
            if (
                pre is not None
                and bytes_fn is not None
                and pre[0] == len(sent)
            ):
                raw_req = pre[1]
            else:
                with TRACER.span("vnode.submit_chunk.encode") as espan:
                    espan.count("pods", len(sent))
                    breq = pb.SubmitJobsRequest()
                    for demand, submitter in self._submit_rows(sent):
                        fill_submit_request(
                            breq.requests.add(), demand, submitter
                        )
            results_cols = None
            resp = None
            try:
                if bytes_fn is not None:
                    raw = bytes_fn(raw_req if raw_req is not None else breq)
                    try:
                        results_cols = coldec.decode_submit_jobs(raw)
                    except coldec.DecodeError as e:
                        self._coldec_fall_back("SubmitJobs", str(e))
                        resp = pb.SubmitJobsResponse.FromString(raw)
                else:
                    resp = self.client.SubmitJobs(breq)
            except RpcError as e:
                if e.code() == StatusCode.UNIMPLEMENTED:
                    self._batch_submit_supported = False
                    _submit_fallbacks.inc()
                    log.warning(
                        "agent does not implement SubmitJobs; "
                        "falling back to per-pod submits"
                    )
                    for it in sent:
                        self._sync_pod_by_name(it.name)
                    return
                if e.code() in _TRANSIENT_RPC:
                    for it in sent:
                        self.events.emit(
                            Pod.KIND, it.name, Reason.POD_PENDING,
                            f"agent unavailable, will retry: {e.code().name}",
                            warning=True,
                        )
                    return
                for it in sent:
                    self.events.emit(
                        Pod.KIND, it.name, Reason.POD_FAILED,
                        f"submit failed: {e.details()}", warning=True,
                    )
                    try:
                        self._fail_pod_name(it.name, f"submit failed: {e.details()}")
                    except NotFound:
                        pass
                return
            _submit_bulk.inc()
            n_results = (
                results_cols.n if results_cols is not None else len(resp.results)
            )
            if n_results != len(sent):
                log.warning(
                    "SubmitJobs returned %d results for %d requests; ignoring",
                    n_results, len(sent),
                )
                return
            accepted: list[tuple[_SubmitItem, int]] = []
            pending: list[tuple[_SubmitItem, str]] = []
            rejected: list[tuple[_SubmitItem, str]] = []
            if results_cols is not None:
                coldec.rows_counter().inc(results_cols.n)
                if results_cols.all_ok:
                    # the dominant storm shape: one vectorized column
                    # read, no per-entry proto objects at all
                    accepted = list(zip(sent, results_cols.job_id.tolist()))
                else:
                    oks = results_cols.ok
                    jids = results_cols.job_id.tolist()
                    for i, it in enumerate(sent):
                        if oks[i]:
                            accepted.append((it, jids[i]))
                            continue
                        ecode = results_cols.error_code[i]
                        code = getattr(
                            StatusCode, ecode, StatusCode.UNKNOWN
                        )
                        if code in _TRANSIENT_RPC:
                            pending.append((it, ecode))
                        else:
                            rejected.append((it, results_cols.error[i] or ecode))
            else:
                for it, entry in zip(sent, resp.results):
                    if entry.ok:
                        accepted.append((it, int(entry.job_id)))
                        continue
                    code = getattr(
                        StatusCode, entry.error_code, StatusCode.UNKNOWN
                    )
                    if code in _TRANSIENT_RPC:
                        pending.append((it, entry.error_code))
                    else:
                        rejected.append((it, entry.error or entry.error_code))
            if accepted:
                self._commit_submits(accepted, span)
            for it, code_name in pending:
                self.events.emit(
                    Pod.KIND, it.name, Reason.POD_PENDING,
                    f"agent unavailable, will retry: {code_name}", warning=True,
                )
            for it, detail in rejected:
                self.events.emit(
                    Pod.KIND, it.name, Reason.POD_FAILED,
                    f"submit failed: {detail}", warning=True,
                )
                try:
                    self._fail_pod_name(it.name, f"submit failed: {detail}")
                except NotFound:
                    pass

    def _commit_submits(self, accepted: list[tuple[_SubmitItem, int]], span) -> None:
        """One row-commit for every accepted job id — the columnar twin
        of ``_submitted_replacement`` + ``update_batch``."""
        table = self.store.table(Pod.KIND)
        c = table.cols
        n = len(accepted)
        names = [it.name for it, _ in accepted]
        expected = np.fromiter((it.rv for it, _ in accepted), np.int64, n)
        labels_new = np.empty(n, object)
        ann_new = np.empty(n, object)
        jids = np.empty(n, object)
        endpoint = self.agent_endpoint
        for k, (it, job_id) in enumerate(accepted):
            labels_new[k] = FrozenDict({**it.labels, "jobid": str(job_id)})
            ann_new[k] = FrozenDict({**it.ann, "agent-endpoint": endpoint})
            jids[k] = (job_id,)

        def writer(rws, sel):
            c.labels[rws] = labels_new[sel]
            c.ann[rws] = ann_new[sel]
            c.job_ids[rws] = jids[sel]
            c.njobs[rws] = 1
            c.phase[rws] = _PH_PENDING
            c.reason[rws] = ""

        results = self.store.update_rows(
            Pod.KIND, names, expected, writer, site="vnode.submit"
        )
        committed = 0
        pairs: list[tuple[str, str]] = []
        for (it, job_id), rc in zip(accepted, results.tolist()):
            if rc == 0:
                continue  # pod deleted mid-submit; terminate cancels
            if rc < 0:
                # racing writer: re-apply on a fresh snapshot, exactly
                # as the per-pod path's optimistic retry would
                try:
                    self.store.replace_update(
                        Pod.KIND, it.name,
                        lambda p, j=job_id: self._submitted_replacement(p, j),
                        site="vnode.submit",
                    )
                except NotFound:
                    continue
            committed += 1
            pairs.append((it.name, f"slurm job {job_id} submitted"))
        self.events.emit_batch(Pod.KIND, Reason.JOB_SUBMITTED, pairs)
        with self._count_lock:
            self.submits_batched += len(accepted)
        span.count("accepted", len(accepted))

    def _refresh_statuses_cols(self, table, rb: _RefreshBatch) -> None:
        if not rb.names:
            return
        with TRACER.span("vnode.status") as span:
            span.count("pods", len(rb.names))
            self._refresh_statuses_cols_traced(table, rb, span)

    def _refresh_statuses_cols_traced(self, table, rb: _RefreshBatch, span) -> None:
        ids, reqs = self._status_reqs_full(rb)
        bytes_fn = self._bytes_rpc("JobsInfo")
        fetched = (
            self._bulk_status_bytes(bytes_fn, reqs)
            if bytes_fn is not None
            else None
        )
        self._apply_status_full(table, rb, span, ids, reqs, fetched)

    def _status_reqs_full(self, rb: _RefreshBatch):
        """The full status pass's fetch plan: unique job ids in first-
        appearance order and their chunked requests."""
        ids: list[int] = []
        seen: set[int] = set()
        for jt in rb.job_ids:
            for jid in jt:
                if jid not in seen:
                    seen.add(jid)
                    ids.append(jid)
        reqs = [
            pb.JobsInfoRequest(job_ids=ids[lo : lo + _BULK_CHUNK])
            for lo in range(0, len(ids), _BULK_CHUNK)
        ]
        return ids, reqs

    def _full_cols_for_commit(self, scratch, s_changed):
        """Tier-2 write columns for the changed rows: served from the
        worker-built commit frames when the frames mirror path attached
        them, span-materialized otherwise. Frame fallbacks (a frame not
        covering a row, truncation, bad utf8) count on
        ``sbt_store_frame_fallback_total`` and re-run the serial arm per
        chunk — value-identical by construction."""
        frames = getattr(scratch, "frames", None)
        if not frames:
            return scratch.full_cols(s_changed)
        return scratch.full_cols_framed(
            s_changed, on_fallback=frame_fallback_counter().inc
        )

    def _commit_status_rows(
        self, table, scratch, s_changed, names_c, expected, full, phase_w
    ) -> np.ndarray:
        """The status commit shared by the full and incremental mirrors.

        Without frames this is the PR-18 serial column scatter: ONE
        ``update_rows`` whose writer appends the new info rows to the
        segment heap and repoints the istart/ilen/phase columns. With
        frames (``scratch.frames`` set), the same committed rows are
        split into writer partitions — maximal consecutive runs owned by
        one decoded chunk — and merged through ``store.apply_frames``
        under one short lock in request order. Equivalence is by
        construction: the segment heap allocates at the tail, so
        consecutive per-part allocs are contiguous and land each info
        row at exactly the offset the one-shot writer would have; part
        order concatenated equals ``names_c`` order, so rv assignment,
        event order, dirty records and commit attribution are identical.
        The compaction probe runs once, in the LAST part's writer — the
        same heap state the serial writer's end-of-call probe sees."""
        h = table.adapter.infos
        c = table.cols

        def make_writer(base: int, compact: bool):
            def writer(rws, sel):
                nc = int(rws.size)
                start = h.alloc(nc)
                tgt = np.arange(start, start + nc, dtype=np.int64)
                gsel = sel + base
                for hcol, acol in _WRITE_COLS:
                    getattr(h, hcol)[tgt] = full[acol][gsel]
                # datetimes derive lazily from the _ts columns on read
                h.submit[tgt] = LAZY_DT
                h.start[tgt] = LAZY_DT
                h.retire(int(c.ilen[rws].sum()))
                c.istart[rws] = tgt
                c.ilen[rws] = 1
                c.phase[rws] = phase_w[gsel]
                if compact:
                    table.adapter._maybe_compact_infos(table)
            return writer

        if not getattr(scratch, "frames", None):
            return self.store.update_rows(
                Pod.KIND, names_c, expected,
                make_writer(0, compact=True), site="vnode.status",
            )
        bounds = scratch._bounds
        ci = np.searchsorted(
            bounds, np.asarray(s_changed, np.int64), side="right"
        ) - 1
        cuts = np.nonzero(np.diff(ci))[0] + 1
        edges = [0, *cuts.tolist(), len(names_c)]
        parts = []
        for k, (lo, hi) in enumerate(zip(edges, edges[1:])):
            parts.append((
                names_c[lo:hi],
                expected[lo:hi],
                make_writer(lo, compact=(k == len(edges) - 2)),
            ))
        outs = self.store.apply_frames(
            Pod.KIND, parts, site="vnode.status",
            partition=self._dirty_partition,
        )
        if not outs:
            return np.zeros(0, np.int64)
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def _apply_status_full(
        self, table, rb: _RefreshBatch, span, ids, reqs, fetched
    ) -> None:
        """Diff + write for a fetched full status pass. ``fetched`` is
        ``_bulk_status_bytes``'s result (or None when the bytes twin is
        unavailable — the pb2 loop re-queries here). Separated from the
        request build so the staged mirror can run the fetch on its
        overlap thread; this half owns every store write and runs on the
        caller's thread in provider order either way."""
        scratch = None
        if fetched is not None:
            state, scratch, _ = fetched
            if state == "unimplemented":
                self._converge_names(rb.names)
                return
            if state == "abort":
                return
            # "fallback": malformed bytes — re-query below on the
            # remembered pb2 path (rare; digest-identical by the fuzz)
        if scratch is None:
            scratch, _ = self._bulk_status_pb2(reqs, rb.names)
            if scratch is None:
                return
        for jid in ids:
            if jid not in scratch.row_of_jid:
                scratch.add_unknown(jid)
        arr = scratch.finalize()
        span.count("jobs_queried", len(ids))
        span.count("rows_decoded", len(scratch.jid))

        n = len(rb.names)
        sidx = np.full(n, -1, np.int64)
        fallback: list[int] = []
        row_of_jid = scratch.row_of_jid
        for i, jt in enumerate(rb.job_ids):
            if len(jt) == 1 and rb.ilen[i] <= 1:
                s = row_of_jid.get(jt[0], -1)
                if s >= 0:
                    sidx[i] = s
                    continue
            fallback.append(i)
        fi = np.nonzero(sidx >= 0)[0]
        h = table.adapter.infos
        c = table.cols
        ci = np.empty(0, np.int64)
        if fi.size:
            with self.store.locked():
                # re-resolve under the lock: a compaction may have moved
                # segments since classification, and a pod whose rv moved
                # must take the conflict-retry path (exactly the object
                # path's optimistic semantics)
                rws = table.rows_for([rb.names[i] for i in fi.tolist()])
                ok = rws >= 0
                cur_rv = c.rv[np.where(ok, rws, 0)]
                ok &= cur_rv == rb.rv[fi]
                ilen = c.ilen[np.where(ok, rws, 0)]
                ok &= ilen <= 1
                stale = fi[~ok]
                fi = fi[ok]
                s = sidx[fi]
                rws = rws[ok]
                prev = c.ilen[rws] == 1
                g = np.where(prev, c.istart[rws], 0)
                diff = ~prev  # no stored info row yet ⇒ changed
                for hcol, acol in _SIGNAL_DIFF_COLS:
                    diff = diff | (getattr(h, hcol)[g] != arr[acol][s])
                phase_stored = c.phase[rws]
            fallback.extend(stale.tolist())
            if fi.size:
                phase_new = PHASE_OF_SINGLE_STATE[arr["state"][s]]
                diff = diff | (phase_new != phase_stored)
                _vector_diff_rows.inc(int(fi.size))
                ci = fi[diff]
        span.count("writes", int(ci.size))
        if ci.size:
            s_changed = sidx[ci]
            phase_w = PHASE_OF_SINGLE_STATE[arr["state"][s_changed]]
            names_c = [rb.names[i] for i in ci.tolist()]
            expected = rb.rv[ci]
            # tier-2 decode: the remaining 12 fields, read from the kept
            # proto refs only for the rows the signal compare flagged
            full = self._full_cols_for_commit(scratch, s_changed)
            results = self._commit_status_rows(
                table, scratch, s_changed, names_c, expected, full, phase_w
            )
            for i, rc in zip(ci.tolist(), results.tolist()):
                if rc <= 0:
                    fallback.append(i)
        if fallback:
            _diff_fallback_rows.inc(len(fallback))
            rows_by_jid: dict[int, list[int]] = {}
            for k, jid in enumerate(scratch.jid):
                rows_by_jid.setdefault(jid, []).append(k)
            for i in sorted(set(fallback)):
                pod = self.store.try_get(Pod.KIND, rb.names[i])
                if pod is None:
                    continue
                queried = tuple(rb.job_ids[i])
                infos: list[JobInfo] = []
                for jid in queried:
                    ks = rows_by_jid.get(jid)
                    if not ks:
                        infos.append(_unknown_info(jid))
                    else:
                        infos.extend(scratch.info_object(k) for k in ks)
                self._record_status(pod, queried, infos)

    def _refresh_statuses_cols_incr(self, table, mc: _MirrorCache) -> None:
        """The cursor-scoped status mirror (PR-11): the same chunked
        JobsInfo round-trips as the full pass (call-count parity — each
        call is one fault-injection draw), but already-applied chunks
        carry ``since_version`` so an idle tick's responses are empty and
        the diff/write machinery runs over RETURNED jobs only. Writes are
        the full path's writes exactly: the agent's contract is that an
        omitted job has not changed since the cursor, so the full diff
        would have found nothing for it."""
        if not mc.rb.names:
            return
        with TRACER.span("vnode.status") as span:
            span.count("pods", len(mc.rb.names))
            self._refresh_statuses_incr_traced(table, mc, span)

    def _refresh_statuses_incr_traced(self, table, mc: _MirrorCache, span) -> None:
        self._prep_status_incr(mc)
        bytes_fn = self._bytes_rpc("JobsInfo")
        fetched = (
            self._bulk_status_bytes(bytes_fn, mc.reqs)
            if bytes_fn is not None
            else None
        )
        self._apply_status_incr(table, mc, span, fetched)

    def _prep_status_incr(self, mc: _MirrorCache) -> None:
        """Restamp the cached chunk requests' cursors BEFORE the fan-out:
        the bytes path serializes the shared request protos from pool
        workers concurrently (and the staged mirror from its overlap
        thread), so the stamp must land while the provider still owns
        them exclusively."""
        cursor = self._jobs_cursor
        for req, full in zip(mc.reqs, mc.full_chunk):
            req.since_version = 0 if full else cursor

    def _apply_status_incr(
        self, table, mc: _MirrorCache, span, fetched
    ) -> None:
        """Diff + write + cursor advance for a fetched cursor pass —
        the main-thread half of the staged mirror (cf.
        :meth:`_apply_status_full`)."""
        rb = mc.rb
        scratch = None
        versions: list[int] = []
        if fetched is not None:
            state, scratch, versions = fetched
            if state == "unimplemented":
                self._converge_names(rb.names)
                return
            if state == "abort":
                return
        if scratch is None:
            scratch, versions = self._bulk_status_pb2(mc.reqs, rb.names)
            if scratch is None:
                return
        span.count("jobs_queried", len(mc.ids))
        span.count("rows_decoded", len(scratch.jid))
        new_cursor = min(versions) if versions else 0
        if len(scratch.jid):
            self._apply_status_changes(table, mc, scratch, span)
        else:
            span.count("writes", 0)
        self._jobs_cursor = new_cursor
        # the classification already dropped the ids that left the set
        self._applied_ids.update(mc.ids[mc.unapplied].tolist())
        # every id in the working set is now applied: later passes over
        # the SAME cache must query every chunk at the cursor — leaving a
        # tail chunk flagged "full" would re-deliver its ~2000 unchanged
        # entries every steady tick (decode cost for nothing)
        mc.unapplied[:] = False
        for k in range(len(mc.full_chunk)):
            mc.full_chunk[k] = False

    def _apply_status_changes(self, table, mc: _MirrorCache, scratch, span) -> None:
        """Diff + write for the pods owning a RETURNED job — the full
        path's locked vectorized compare and row-write, restricted to
        candidates (everything else is unchanged by the cursor contract).
        """
        rb = mc.rb
        arr = scratch.finalize()
        row_of_jid = scratch.row_of_jid
        cand: list[int] = []
        seen: set[int] = set()
        idx_of = mc.idx_of_name
        for jid in row_of_jid:
            for name in mc.names_of_jid.get(jid, ()):
                i = idx_of[name]
                if i not in seen:
                    seen.add(i)
                    cand.append(i)
        cand.sort()
        cand_arr = np.asarray(cand, np.int64)
        names_cand = [rb.names[i] for i in cand]
        rv_cand = rb.rv[cand_arr]
        n = len(cand)
        sidx = np.full(n, -1, np.int64)
        fallback: list[int] = []  # rb indices
        for k, i in enumerate(cand):
            jt = rb.job_ids[i]
            if len(jt) == 1 and rb.ilen[i] <= 1:
                s = row_of_jid.get(jt[0], -1)
                if s >= 0:
                    sidx[k] = s
                    continue
            fallback.append(i)
        fi = np.nonzero(sidx >= 0)[0]
        h = table.adapter.infos
        c = table.cols
        ci = np.empty(0, np.int64)
        if fi.size:
            with self.store.locked():
                rws = table.rows_for([names_cand[int(k)] for k in fi])
                ok = rws >= 0
                cur_rv = c.rv[np.where(ok, rws, 0)]
                ok &= cur_rv == rv_cand[fi]
                ilen = c.ilen[np.where(ok, rws, 0)]
                ok &= ilen <= 1
                stale = fi[~ok]
                fi = fi[ok]
                s = sidx[fi]
                rws = rws[ok]
                prev = c.ilen[rws] == 1
                g = np.where(prev, c.istart[rws], 0)
                diff = ~prev  # no stored info row yet ⇒ changed
                for hcol, acol in _SIGNAL_DIFF_COLS:
                    diff = diff | (getattr(h, hcol)[g] != arr[acol][s])
                phase_stored = c.phase[rws]
            fallback.extend(cand_arr[stale].tolist())
            if fi.size:
                phase_new = PHASE_OF_SINGLE_STATE[arr["state"][s]]
                diff = diff | (phase_new != phase_stored)
                _vector_diff_rows.inc(int(fi.size))
                ci = fi[diff]
        span.count("writes", int(ci.size))
        if ci.size:
            s_changed = sidx[ci]
            phase_w = PHASE_OF_SINGLE_STATE[arr["state"][s_changed]]
            names_c = [names_cand[int(k)] for k in ci]
            expected = rv_cand[ci]
            full = self._full_cols_for_commit(scratch, s_changed)
            results = self._commit_status_rows(
                table, scratch, s_changed, names_c, expected, full, phase_w
            )
            for k, rc in zip(ci.tolist(), results.tolist()):
                if rc <= 0:
                    fallback.append(int(cand_arr[k]))
        if fallback:
            _diff_fallback_rows.inc(len(fallback))
            rows_by_jid: dict[int, list[int]] = {}
            for k2, jid in enumerate(scratch.jid):
                rows_by_jid.setdefault(jid, []).append(k2)
            for i in sorted(set(fallback)):
                pod = self.store.try_get(Pod.KIND, rb.names[i])
                if pod is None:
                    continue
                queried = tuple(rb.job_ids[i])
                stored_by_id: dict[int, list] = {}
                for info in pod.status.job_infos:
                    stored_by_id.setdefault(info.id, []).append(info)
                infos: list[JobInfo] = []
                for jid in queried:
                    ks = rows_by_jid.get(jid)
                    if ks:
                        infos.extend(scratch.info_object(k2) for k2 in ks)
                    elif jid in stored_by_id:
                        # omitted by the cursor ⇒ unchanged: the stored
                        # rows ARE the agent's state (modulo the ticking
                        # run_time counter, which the diff ignores)
                        infos.extend(stored_by_id[jid])
                    else:
                        infos.append(_unknown_info(jid))
                self._record_status(pod, queried, infos)

    def _converge_names(self, names: list[str]) -> None:
        """Materialize views and run the object-path converge — the
        remembered-fallback seam for agents without the bulk RPCs."""
        pods = [
            p for n in names if (p := self.store.try_get(Pod.KIND, n)) is not None
        ]
        self._converge(pods)

    def _converge(self, pods: list[Pod]) -> None:
        """Converge pods needing a per-pod action, partitioned into the
        submit group (batched through chunked ``SubmitJobs`` RPCs, chunks
        fanned out across the pool) and everything else — terminates and
        per-pod refreshes — which rides the PodSyncWorkers resync
        (virtual-kubelet.go:298-310) as before.

        The rest group runs FIRST: a terminate frees cluster capacity the
        batch submits may need, and the ordering is deterministic either
        way (list order within each group)."""
        if not pods:
            return
        submit: list[Pod] = []
        rest: list[Pod] = []
        for p in pods:
            if (
                self._batch_submit_supported
                and not p.meta.deleted
                and p.spec.role == PodRole.SIZECAR
                and not p.status.job_ids
            ):
                submit.append(p)
            else:
                rest.append(p)
        if not self._batch_submit_supported and any(
            not p.meta.deleted
            and p.spec.role == PodRole.SIZECAR
            and not p.status.job_ids
            for p in rest
        ):
            _submit_fallbacks.inc()
        if rest:
            self._pool_map(self._sync_pod_safe, rest)
        if submit:
            chunks = [
                submit[lo : lo + _SUBMIT_CHUNK]
                for lo in range(0, len(submit), _SUBMIT_CHUNK)
            ]
            self._pool_map(self._submit_chunk_safe, chunks)

    def _pool_map(self, fn, items: list) -> None:
        """Run ``fn`` over ``items`` through the shared pod-sync pool —
        in parallel across ``sync_workers`` threads, since each item can
        block on an agent RPC (submit = one sbatch exec)."""
        parent = TRACER.current()
        if parent is not None and parent.sampled:
            # explicit-parent propagation: pool workers run outside the
            # submitting thread's contextvar, so seed it per item — spans
            # a chunk opens (submit spans, rpc client spans) then parent
            # into the sync span instead of starting orphan traces
            inner = fn

            def fn(item, _parent=parent, _inner=inner):
                with with_current_span(_parent):
                    return _inner(item)

        if len(items) <= 1 or self.sync_workers == 1:
            for item in items:
                fn(item)
            return
        # sync() runs concurrently (partition ticker + Configurator.sync_now
        # from Bridge.delete/converge_once callers), so the lazy build is
        # locked; built once and reused — sync runs every ~250 ms in steady
        # state and a per-tick pool would churn thread create/teardown
        with self._pool_lock:
            if self._pool is None and not self._pool_closed:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=self.sync_workers,
                    thread_name_prefix=f"podsync-{self.partition}",
                )
            pool = self._pool
        if pool is None:
            for item in items:  # deregistered mid-call: converge serially
                fn(item)
            return
        try:
            list(pool.map(fn, items))
        except RuntimeError:
            # pool shut down between the snapshot and the map (teardown
            # race): finish this tick serially rather than abandon pods
            for item in items:
                fn(item)

    def _sync_pod_safe(self, pod: Pod) -> None:
        try:
            self.sync_pod(pod)
        except NotFound:
            pass  # pod deleted mid-sync
        except Exception:
            log.exception("sync pod %s failed", pod.name)

    def sync_pod(self, pod: Pod) -> None:
        if pod.meta.deleted:
            self._terminate_pod(pod)
            return
        if pod.spec.role != PodRole.SIZECAR:
            return
        if not pod.status.job_ids:
            self._submit_pod(pod)
        elif pod.status.phase not in PodPhase.TERMINAL:
            # SUCCEEDED/FAILED pods are done: querying their jobs forever
            # was one RPC per dead pod per sync tick (PR-3 satellite)
            self._refresh_status(pod)

    def _submit_request(self, pod: Pod) -> pb.SubmitJobRequest | None:
        """The submit request for one sizecar pod, or None after failing a
        script-less pod. The pod UID (plus the preemption requeue's
        submit-generation, scheduler._preempt) is the submitter id, so
        retries dedupe agent-side."""
        demand = pod.spec.demand
        if demand is None or not demand.script.strip():
            try:
                self._fail_pod(pod, "sizecar pod has no script")
            except NotFound:
                pass  # deleted mid-converge: nothing left to fail — and a
                # chunk caller must not lose its batch-mates over it
            return None
        submitter = pod.meta.uid
        gen = pod.meta.annotations.get("submit-generation", "")
        if gen:
            submitter = f"{submitter}#g{gen}"
        if pod.spec.placement_hint and not demand.nodelist:
            # the solver's choice rides to `sbatch --nodelist`
            demand = dataclasses.replace(demand, nodelist=pod.spec.placement_hint)
        return demand_to_submit(demand, submitter_id=submitter)

    def _submitted_replacement(self, pod: Pod, job_id: int) -> Pod:
        """The post-submit pod: job id recorded, phase Pending — shared by
        the per-pod and batched submit paths so they can never drift."""
        return fast_replace(
            pod,
            meta=fast_replace(
                pod.meta,
                labels={**pod.meta.labels, "jobid": str(job_id)},
                annotations={
                    **pod.meta.annotations,
                    "agent-endpoint": self.agent_endpoint,
                },
            ),
            status=frozen_replace(
                pod.status,
                job_ids=(job_id,),
                phase=PodPhase.PENDING,
                reason="",
            ),
        )

    def _submit_pod(self, pod: Pod) -> None:
        """CreatePod equivalent (provider.go:35-60) — the per-pod form,
        used by direct ``sync_pod`` callers and the fallback when the
        agent lacks the batched SubmitJobs RPC."""
        req = self._submit_request(pod)
        if req is None:
            return
        try:
            resp = self.client.SubmitJob(req)
        except RpcError as e:
            if e.code() in _TRANSIENT_RPC:
                # agent unreachable ≠ bad job: stay Pending and let the
                # next sync retry (the agent's submit ledger makes the
                # retry idempotent even if the first attempt landed)
                self.events.event(
                    pod, Reason.POD_PENDING,
                    f"agent unavailable, will retry: {e.code().name}",
                    warning=True,
                )
                return
            self.events.event(
                pod, Reason.POD_FAILED, f"submit failed: {e.details()}", warning=True
            )
            self._fail_pod(pod, f"submit failed: {e.details()}")
            return
        job_id = int(resp.job_id)
        self.store.replace_update(
            Pod.KIND, pod.name,
            lambda p: self._submitted_replacement(p, job_id),
            site="vnode.submit",
        )
        with self._count_lock:
            self.submits_fallback += 1
        self.events.event(pod, Reason.JOB_SUBMITTED, f"slurm job {job_id} submitted")

    def _submit_chunk_safe(self, pods: list[Pod]) -> None:
        try:
            self._submit_chunk(pods)
        except Exception:
            log.exception(
                "batch submit of %d pods failed", len(pods)
            )

    def _submit_chunk(self, pods: list[Pod]) -> None:
        """One batched submit: ≤ ``_SUBMIT_CHUNK`` pods, one SubmitJobs
        round-trip, ONE ``update_batch`` commit for every accepted job id.

        Per-item results get exactly the per-pod path's treatment — a
        transient item stays Pending for the next sync, a rejected item
        fails its pod — and an agent answering UNIMPLEMENTED flips the
        provider to the per-pod pool path for good (remembered, like the
        JobsInfo fallback)."""
        with TRACER.span("vnode.submit_chunk") as span:
            span.count("pods", len(pods))
            self._submit_chunk_traced(pods, span)

    def _submit_chunk_traced(self, pods: list[Pod], span) -> None:
        items: list[Pod] = []
        reqs: list[pb.SubmitJobRequest] = []
        for pod in pods:
            req = self._submit_request(pod)
            if req is not None:
                items.append(pod)
                reqs.append(req)
        if not reqs:
            return
        try:
            resp = self.client.SubmitJobs(pb.SubmitJobsRequest(requests=reqs))
        except RpcError as e:
            if e.code() == StatusCode.UNIMPLEMENTED:
                # remember and submit per pod from now on
                self._batch_submit_supported = False
                _submit_fallbacks.inc()
                log.warning(
                    "agent does not implement SubmitJobs; "
                    "falling back to per-pod submits"
                )
                for pod in items:
                    self._sync_pod_safe(pod)
                return
            if e.code() in _TRANSIENT_RPC:
                # agent unreachable ≠ bad jobs: the whole chunk stays
                # Pending and retries next sync (ledger-deduped)
                for pod in items:
                    self.events.event(
                        pod, Reason.POD_PENDING,
                        f"agent unavailable, will retry: {e.code().name}",
                        warning=True,
                    )
                return
            for pod in items:
                self.events.event(
                    pod, Reason.POD_FAILED,
                    f"submit failed: {e.details()}", warning=True,
                )
                try:
                    self._fail_pod(pod, f"submit failed: {e.details()}")
                except NotFound:
                    pass  # deleted mid-chunk: don't drop the rest
            return
        _submit_bulk.inc()
        if len(resp.results) != len(items):
            # a malformed response must not mis-pair pods with job ids;
            # leave the chunk Pending and let the next sync retry
            log.warning(
                "SubmitJobs returned %d results for %d requests; ignoring",
                len(resp.results), len(items),
            )
            return
        accepted: list[tuple[Pod, int]] = []
        pending: list[tuple[Pod, str]] = []
        rejected: list[tuple[Pod, str]] = []
        for pod, entry in zip(items, resp.results):
            if entry.ok:
                accepted.append((pod, int(entry.job_id)))
                continue
            code = getattr(
                StatusCode, entry.error_code, StatusCode.UNKNOWN
            )
            if code in _TRANSIENT_RPC:
                pending.append((pod, entry.error_code))
            else:
                rejected.append((pod, entry.error or entry.error_code))
        if accepted:
            results = self.store.update_batch(
                [
                    self._submitted_replacement(pod, job_id)
                    for pod, job_id in accepted
                ],
                site="vnode.submit",
            )
            for (pod, job_id), res in zip(accepted, results):
                if isinstance(res, NotFound):
                    continue  # pod deleted mid-submit; terminate cancels
                if isinstance(res, Exception):
                    # racing writer: re-apply on a fresh snapshot, exactly
                    # as the per-pod path's optimistic retry would
                    try:
                        self.store.replace_update(
                            Pod.KIND, pod.name,
                            lambda p, j=job_id: self._submitted_replacement(p, j),
                            site="vnode.submit",
                        )
                    except NotFound:
                        continue
                self.events.event(
                    pod, Reason.JOB_SUBMITTED, f"slurm job {job_id} submitted"
                )
            with self._count_lock:
                self.submits_batched += len(accepted)
            span.count("accepted", len(accepted))
        for pod, code_name in pending:
            self.events.event(
                pod, Reason.POD_PENDING,
                f"agent unavailable, will retry: {code_name}", warning=True,
            )
        for pod, detail in rejected:
            self.events.event(
                pod, Reason.POD_FAILED, f"submit failed: {detail}", warning=True
            )
            try:
                self._fail_pod(pod, f"submit failed: {detail}")
            except NotFound:
                pass

    def _refresh_status(self, pod: Pod) -> None:
        """GetPodStatus equivalent (provider.go:195-219) — the per-pod
        form, used by direct ``sync_pod`` callers and the fallback when
        the agent lacks the batched RPC."""
        queried = pod.status.job_ids
        infos: list[JobInfo] = []
        for job_id in queried:
            try:
                resp = self.client.JobInfo(pb.JobInfoRequest(job_id=job_id))
            except RpcError:
                infos.append(_unknown_info(job_id))
                continue
            infos.extend(job_info_from_proto(m) for m in resp.info)
        self._record_status(pod, queried, infos)

    def _refresh_statuses(self, pods: list[Pod]) -> None:
        """The batched status mirror: ONE JobsInfo round-trip for every
        live job on this node, then diff-only writes — a pod whose job
        state did not change costs zero store writes."""
        if not pods:
            return
        with TRACER.span("vnode.status") as span:
            span.count("pods", len(pods))
            self._refresh_statuses_traced(pods, span)

    def _refresh_statuses_traced(self, pods: list[Pod], span) -> None:
        if not self._bulk_supported:
            # pre-PR-3 agent: per-pod queries, but still through the
            # sync_workers pool — the serial form would be a ~10× sync
            # latency regression for exactly these deployments
            _bulk_fallbacks.inc()
            self._converge(pods)
            return
        ids: list[int] = []
        seen: set[int] = set()
        for p in pods:
            for jid in p.status.job_ids:
                if jid not in seen:
                    seen.add(jid)
                    ids.append(jid)
        by_id: dict[int, list[JobInfo]] = {}
        # chunked: one logical bulk query, bounded per-RPC payload
        for lo in range(0, len(ids), _BULK_CHUNK):
            chunk = ids[lo : lo + _BULK_CHUNK]
            try:
                resp = self.client.JobsInfo(pb.JobsInfoRequest(job_ids=chunk))
            except RpcError as e:
                if e.code() == StatusCode.UNIMPLEMENTED:
                    # remember and converge per pod from now on
                    self._bulk_supported = False
                    _bulk_fallbacks.inc()
                    log.warning(
                        "agent does not implement JobsInfo; "
                        "falling back to per-pod status queries"
                    )
                    self._converge(pods)
                    return
                # transient failure: keep current statuses and let the
                # level-triggered loop retry next sync — flapping 50k pods
                # to UNKNOWN over one blip would be worse than lag
                log.warning("bulk status query failed: %s", e.details())
                return
            _bulk_queries.inc()
            for entry in resp.jobs:
                jid = int(entry.job_id)
                infos = [job_info_from_proto(m) for m in entry.info]
                if not entry.found or not infos:
                    infos = [_unknown_info(jid)]
                by_id[jid] = infos
        span.count("jobs_queried", len(ids))
        span.count("rows_decoded", sum(len(v) for v in by_id.values()))
        # diff against the snapshots we already hold, then commit every
        # changed pod under ONE store lock acquisition; a conflict (racing
        # writer) falls back to the per-pod optimistic retry
        changed: list[tuple[Pod, tuple[int, ...], list[JobInfo], str]] = []
        for pod in pods:
            queried = pod.status.job_ids
            infos = []
            for jid in queried:
                infos.extend(by_id.get(jid) or [_unknown_info(jid)])
            phase = pod_phase_for([i.state for i in infos])
            if pod.status.phase == phase and _infos_equivalent(
                pod.status.job_infos, infos
            ):
                continue  # zero store writes on the steady path
            changed.append((pod, queried, infos, phase))
        span.count("writes", len(changed))
        if not changed:
            return
        results = self.store.update_batch(
            [
                _status_replacement(pod, infos, phase)
                for pod, _, infos, phase in changed
            ],
            site="vnode.status",
        )
        for (pod, queried, infos, phase), res in zip(changed, results):
            if isinstance(res, Exception):
                self._record_status(pod, queried, infos)

    def _record_status(
        self, pod: Pod, queried: tuple[int, ...], infos: list[JobInfo]
    ) -> None:
        phase = pod_phase_for([i.state for i in infos])

        def build(p: Pod):
            if p.status.job_ids != queried:
                return None  # preempted/requeued mid-query — stale state
            if p.status.phase == phase and _infos_equivalent(
                p.status.job_infos, infos
            ):
                return None
            return _status_replacement(p, infos, phase)

        try:
            self.store.replace_update(
                Pod.KIND, pod.name, build, site="vnode.status"
            )
        except NotFound:
            pass

    def _terminate_pod(self, pod: Pod) -> None:
        """DeletePod equivalent (provider.go:156-181): cancel every owned
        job, then drop the object."""
        for job_id in pod.status.job_ids:
            try:
                self.client.CancelJob(pb.CancelJobRequest(job_id=job_id))
            except RpcError as e:
                log.warning("cancel job %d: %s", job_id, e.details())
        try:
            self.store.delete(Pod.KIND, pod.name)
        except NotFound:
            pass

    def _fail_pod(self, pod: Pod, reason: str) -> None:
        def record(p: Pod):
            p.status.phase = PodPhase.FAILED
            p.status.reason = reason

        self.store.mutate(Pod.KIND, pod.name, record, site="vnode.fail")

    # ---- logs ----

    def pod_logs(self, pod_name: str, *, follow: bool = False) -> Iterator[bytes]:
        """GetContainerLogs equivalent (provider.go:246-302): while the job
        runs and follow is set, TailFile; otherwise OpenFile stdout (and
        stderr when distinct)."""
        pod: Pod = self.store.get(Pod.KIND, pod_name)
        infos = pod.status.job_infos
        if not infos:
            return
        info = infos[0]
        running = info.state == JobStatus.RUNNING
        if follow and running:

            def requests():
                yield pb.TailFileRequest(path=info.std_out, action=pb.FOLLOW)
                # drain-and-close once the job leaves RUNNING
                while True:
                    time.sleep(0.2)
                    try:
                        resp = self.client.JobState(pb.JobStateRequest(job_id=info.id))
                    except RpcError:
                        break
                    if resp.status != pb.RUNNING:
                        break
                yield pb.TailFileRequest(
                    path=info.std_out, action=pb.READ_TO_END_AND_CLOSE
                )

            for chunk in self.client.TailFile(requests()):
                yield chunk.content
            return
        paths = [info.std_out]
        if info.std_err and info.std_err != info.std_out:
            paths.append(info.std_err)
        for path in paths:
            try:
                for chunk in self.client.OpenFile(pb.OpenFileRequest(path=path)):
                    yield chunk.content
            except RpcError as e:
                log.warning("open %s: %s", path, e.details())
