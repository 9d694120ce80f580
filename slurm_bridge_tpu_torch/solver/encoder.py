"""Incremental tick encoding — the cross-tick cache over snapshot.py.

``encode_cluster``/``encode_jobs`` lower the whole world every call. That
is the right shape for a cold start, but the scheduler's steady state is a
no-progress retry loop: the same 10k nodes and the same pending backlog,
re-lowered from Python every tick, dominated end-to-end latency while the
solver itself ran in tens of milliseconds (the VirtualFlow lesson —
decouple the model from per-pod bookkeeping; PAPERS.md).

Two caches fix that:

- :class:`EncodedInventory` persists the ClusterSnapshot, ``name_idx`` and
  the partition/feature code tables across ticks. A refresh with the SAME
  list objects (the scheduler's ``inventory_ttl`` window) is free; fresh
  RPC results are diffed column-wise and only changed rows are rewritten
  (drain/resume, allocation changes); a node set or partition layout
  change rebuilds vectorized, carrying the feature-code table forward so
  job rows stay comparable.
- :class:`JobRowCache` keeps each job's encoded shard scalars keyed by a
  caller-supplied (uid, generation) pair, so a pod pending across ticks is
  parsed once; a tick's batch assembly is one ``np.repeat`` over cached
  rows. Entries are invalidated when the inventory's code tables move
  (rebuild or feature-table growth — a cached "impossible feature"
  sentinel must be re-resolved when the cluster learns the feature).

Snapshot views returned by :meth:`EncodedInventory.refresh` share the
read-only columns with the cache but carry a fresh ``free`` copy, because
the scheduler releases incumbent usage into ``free`` in place.
"""

from __future__ import annotations

import numpy as np

from slurm_bridge_tpu_torch.core.types import JobDemand, NodeInfo, PartitionInfo
from slurm_bridge_tpu_torch.obs.metrics import REGISTRY
from slurm_bridge_tpu_torch.solver.snapshot import (
    ClusterSnapshot,
    JobBatch,
    batch_from_scalars,
    job_scalars,
    node_columns,
    node_dynamic_arrays,
    node_partition_map,
)

_cache_hits = REGISTRY.counter(
    "sbt_scheduler_encode_cache_hits_total",
    "encode cache hits, labeled by cache (inventory|jobs) and kind",
)
_cache_misses = REGISTRY.counter(
    "sbt_scheduler_encode_cache_misses_total",
    "encode cache misses, labeled by cache (inventory|jobs)",
)


class EncodedInventory:
    """Cross-tick ClusterSnapshot cache with column-diff delta refresh."""

    def __init__(self) -> None:
        self._nodes_ref: list[NodeInfo] | None = None
        self._parts_ref: list[PartitionInfo] | None = None
        self._part_layout: tuple | None = None
        self._names: list[str] | None = None
        self._cols: dict[str, np.ndarray] | None = None
        self._states: list[str] | None = None
        self._feats: list[tuple[str, ...]] | None = None
        self._capacity: np.ndarray | None = None
        self._free: np.ndarray | None = None
        self._features: np.ndarray | None = None
        self._partition_of: np.ndarray | None = None
        self.partition_codes: dict[str, int] = {}
        self.feature_codes: dict[str, int] = {}
        self.name_idx: dict[str, int] = {}
        #: bumped on every full (re)build — job-row cache entries encoded
        #: against an older rev hold stale partition codes
        self.rev: int = 0
        #: rows rewritten by the last delta refresh (observability + tests)
        self.last_delta_rows: int = 0

    # ---- public API ----

    def codes_token(self) -> tuple[int, int]:
        """Identity of the code tables a cached job row depends on: the
        build rev (partition codes) and the feature-table size (a grown
        table re-resolves previously-impossible feature requirements)."""
        return (self.rev, len(self.feature_codes))

    def refresh(
        self, nodes: list[NodeInfo], partitions: list[PartitionInfo]
    ) -> ClusterSnapshot:
        """Return the current snapshot, re-encoding as little as possible."""
        if nodes is self._nodes_ref and partitions is self._parts_ref:
            # the scheduler's inventory_ttl window served the same lists:
            # nothing can have changed underneath them
            _cache_hits.inc(cache="inventory", kind="identity")
            self.last_delta_rows = 0
            return self._view()
        layout = tuple((p.name, p.nodes) for p in partitions)
        if (
            self._names is not None
            and layout == self._part_layout
            and len(nodes) == len(self._names)
            and all(nd.name == nm for nd, nm in zip(nodes, self._names))
        ):
            self._apply_deltas(nodes)
            self._nodes_ref, self._parts_ref = nodes, partitions
            _cache_hits.inc(cache="inventory", kind="delta")
            return self._view()
        self._rebuild(nodes, partitions, layout)
        _cache_misses.inc(cache="inventory")
        return self._view()

    # ---- internals ----

    def _view(self) -> ClusterSnapshot:
        return ClusterSnapshot(
            node_names=self._names,
            capacity=self._capacity,
            free=self._free.copy(),  # the scheduler mutates free in place
            partition_of=self._partition_of,
            features=self._features,
            partition_codes=self.partition_codes,
            feature_codes=self.feature_codes,
        )

    def _rebuild(
        self,
        nodes: list[NodeInfo],
        partitions: list[PartitionInfo],
        layout: tuple,
    ) -> None:
        # feature codes survive a rebuild on purpose: bit assignments stay
        # stable across node add/remove, so cached job feature masks remain
        # *valid* (the codes_token still invalidates them if the table grew)
        self.partition_codes, node_part = node_partition_map(partitions)
        self._names = [nd.name for nd in nodes]
        self._cols = node_columns(nodes)
        self._states = [nd.state for nd in nodes]
        self._feats = [nd.features for nd in nodes]
        self._capacity, self._free, self._features = node_dynamic_arrays(
            nodes, self._cols, self.feature_codes
        )
        self._partition_of = np.fromiter(
            (node_part.get(nm, -1) for nm in self._names),
            np.int32,
            len(self._names),
        )
        self.name_idx = {nm: i for i, nm in enumerate(self._names)}
        self._part_layout = layout
        self._nodes_ref, self._parts_ref = nodes, partitions
        self.rev += 1
        self.last_delta_rows = len(self._names)

    def _apply_deltas(self, nodes: list[NodeInfo]) -> None:
        """Same node set, fresh readings: rewrite only the changed rows."""
        new_cols = node_columns(nodes)
        changed = np.zeros(len(nodes), dtype=bool)
        for key, col in new_cols.items():
            changed |= col != self._cols[key]
        # categorical columns: identity-compare the Python values (cheap —
        # interned strings / shared tuples dominate) without re-deriving
        # schedulability or masks for unchanged rows
        for i, nd in enumerate(nodes):
            if nd.state != self._states[i] or nd.features != self._feats[i]:
                changed[i] = True
        idx = np.nonzero(changed)[0]
        self.last_delta_rows = int(idx.size)
        if idx.size:
            sub = [nodes[i] for i in idx]
            sub_cols = {k: v[idx] for k, v in new_cols.items()}
            cap, free, feats = node_dynamic_arrays(
                sub, sub_cols, self.feature_codes
            )
            self._capacity[idx] = cap
            self._free[idx] = free
            self._features[idx] = feats
            for i in idx:
                self._states[i] = nodes[i].state
                self._feats[i] = nodes[i].features
            self._cols = new_cols


#: column name → (slot in a job_scalars row, dtype)
_JOB_COLS = (
    ("cpu", 0, np.float64),
    ("mem", 1, np.float64),
    ("gpu", 2, np.float64),
    ("part", 3, np.int32),
    ("feat", 4, np.uint32),
    ("nshards", 5, np.int64),
    ("prio", 6, np.float64),
)


class JobRowCache:
    """Encode-once job rows, keyed by (uid, generation) + code tables.

    Rows live as parallel per-job column arrays, not per-key tuples: the
    steady-state tick (the same pending backlog retried) compares the key
    LIST for equality and assembles the batch with pure NumPy takes —
    no per-job Python work at all. A changed backlog gathers surviving
    rows by index and parses only the arrivals through job_scalars."""

    def __init__(self) -> None:
        self._keys: list[object] | None = None
        self._index: dict[object, int] = {}
        self._cols: dict[str, np.ndarray] | None = None
        self._token: object = object()  # matches no caller token
        self.last_hits: int = 0
        self.last_misses: int = 0

    def encode(
        self,
        keys: list[object],
        demands: list[JobDemand],
        snapshot: ClusterSnapshot,
        *,
        codes_token: object = None,
        priorities: list[float] | None = None,
    ) -> JobBatch:
        """Assemble the tick's JobBatch, reusing cached rows where the key
        and code tables match. ``keys[i]`` identifies ``demands[i]`` across
        ticks (the scheduler passes (pod uid, resource_version)); entries
        whose key vanished from ``keys`` are dropped (departed pods)."""
        n = len(keys)
        if (
            self._cols is not None
            and codes_token == self._token
            and keys == self._keys
        ):
            hits, misses = n, 0
        else:
            old = self._index if codes_token == self._token else {}
            idx = np.fromiter((old.get(k, -1) for k in keys), np.int64, n)
            miss_pos = np.nonzero(idx < 0)[0]
            hits, misses = n - int(miss_pos.size), int(miss_pos.size)
            if hits and self._cols is not None:
                take = np.where(idx >= 0, idx, 0)
                cols = {nm: arr[take] for nm, arr in self._cols.items()}
            else:
                cols = {
                    nm: np.zeros(n, dtype=dt) for nm, _, dt in _JOB_COLS
                }
            if misses:
                from slurm_bridge_tpu_torch.solver.snapshot import job_scalars_batch

                miss_cols = job_scalars_batch(
                    [demands[p] for p in miss_pos.tolist()], snapshot
                )
                for nm, slot, dt in _JOB_COLS:
                    cols[nm][miss_pos] = miss_cols[slot].astype(dt)
            self._cols = cols
            self._keys = list(keys)
            self._index = {k: i for i, k in enumerate(keys)}
            self._token = codes_token
        self.last_hits, self.last_misses = hits, misses
        if hits:
            _cache_hits.inc(hits, cache="jobs", kind="row")
        if misses:
            _cache_misses.inc(misses, cache="jobs")
        return self._assemble(priorities)

    def _assemble(self, priorities: list[float] | None) -> JobBatch:
        """Batch arrays from the cached columns — fresh arrays every call
        (callers mutate batches in place), one np.repeat for gang fan-out."""
        c = self._cols
        if priorities is not None:
            prio = np.asarray(priorities, np.float64)
        else:
            prio = c["prio"]
        job_of = np.repeat(
            np.arange(len(self._keys), dtype=np.int32), c["nshards"]
        )
        demand = np.stack([c["cpu"], c["mem"], c["gpu"]], axis=1).astype(
            np.float32
        )
        return JobBatch(
            demand=demand[job_of],
            partition_of=c["part"][job_of],
            req_features=c["feat"][job_of],
            priority=prio.astype(np.float32)[job_of],
            gang_id=job_of.copy(),
            job_of=job_of,
        )
