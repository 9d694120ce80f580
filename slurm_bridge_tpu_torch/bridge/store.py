"""In-process object store — the API-server seam of the control plane.

Columnar hot state (PR-6): the high-churn kinds (``Pod``, ``BridgeJob``)
are stored as column-oriented tables (:mod:`bridge.colstore` machinery,
:mod:`bridge.columns` schemas) instead of frozen object graphs. Every
caller keeps this class's contract — ``get``/``list`` still hand out
immutable frozen snapshots (materialized lazily, cached per resource
version), writers still pay optimistic concurrency, watches/indexes/
``changes_since``/commit attribution behave identically — but the hot
write paths (:meth:`update_rows`, :meth:`create_rows`) commit straight
to rows, so a cold-start tick's ~135k commits build zero frozen objects
for anything nothing reads.

The reference's controllers converge on the K8s API server: optimistic
concurrency via resourceVersion, label-selector lists, watches feeding
level-triggered reconcilers, owner references for cascade behavior.
This store reproduces exactly that contract in-process so every bridge
component keeps the reference's architecture (SURVEY.md §3 call stacks)
while the framework runs standalone. Swapping this for a real kube client
retargets the bridge at an actual cluster — the interface is the seam.

Read path (the PR-3 rework): reads hand out **immutable copy-on-read
snapshots** — the stored object itself, frozen once at write time
(:mod:`bridge.freeze`) — instead of deep-copying on every ``get``/``list``.
Mutating a snapshot raises :class:`freeze.FrozenInstanceError`; writers go
through :meth:`mutate` / :meth:`get_for_update`, which hand them a private
thawed copy. At the 100k-object headline shape this removes the dominant
cost of the reconcile tick (BASELINE.md PR-2: 14.3 s of store deep-copies
per tick).

Write path: writers pass fresh objects (``update``/``create`` take
ownership and freeze the argument in place); :meth:`update_batch` applies
many optimistic-concurrency writes under ONE lock acquisition — the
scheduler's bind loop rides it.

Indexes: a secondary index on ``(kind, spec.node_name)`` serves each
virtual-node provider exactly its own pods (:meth:`list_by_node`), and a
per-kind monotonic dirty-set keyed by ``resource_version``
(:meth:`changes_since`) lets level-triggered consumers scan only what
changed since their last pass.

Objects are stored by (kind, name). Writers must pass the object they last
read; a stale ``meta.resource_version`` raises :class:`Conflict`, same as
a 409 from the API server (controllers retry via requeue).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
import weakref
from typing import NamedTuple

import numpy as np

from slurm_bridge_tpu_torch.bridge import columns as _columns
from slurm_bridge_tpu_torch.bridge.colstore import ROWS_GAUGE
from slurm_bridge_tpu_torch.bridge.freeze import (
    FrozenInstanceError,
    freeze,
    thaw,
)
from slurm_bridge_tpu_torch.obs.metrics import REGISTRY, Histogram
from slurm_bridge_tpu_torch.obs.tracing import TRACER, current_span

__all__ = [
    "AlreadyExists",
    "Conflict",
    "FrozenInstanceError",
    "NotFound",
    "ObjectStore",
    "StoreEvent",
]

_list_seconds = REGISTRY.histogram(
    "sbt_store_list_seconds",
    "store list/list_by_node wall time per call (copy-on-read path)",
    buckets=Histogram.FAST_BUCKETS,
)

_frames_applied = REGISTRY.counter(
    "sbt_store_frames_applied_total",
    "rows committed through the partitioned frame-merge path "
    "(ObjectStore.apply_frames)",
)
_frame_fallback = REGISTRY.counter(
    "sbt_store_frame_fallback_total",
    "commit-frame payload fallbacks: rows whose frame was missing or "
    "malformed and were re-materialized on the serial span arm",
)


def frame_fallback_counter():
    """The frame-fallback counter, for the consumers (vnode) that count
    per-chunk serial re-runs without importing the metrics registry."""
    return _frame_fallback


class _CommitsCollector:
    """``sbt_store_commits_total{kind,site}`` — a scrape-time collector.

    The source of truth is each live store's ``commit_counts`` dict,
    incremented inline under the store lock (a plain dict add — no metric
    lock, no label-tuple sort on the 135k-commits-per-tick path); this
    object only SUMS those dicts when /metrics renders. Counts of
    garbage-collected stores are folded into ``_retired`` so the exposed
    counter stays monotonic for the life of the process.
    """

    name = "sbt_store_commits_total"
    help = "store create/update commits by object kind and callsite"

    def __init__(self):
        self._stores: weakref.WeakSet = weakref.WeakSet()
        self._retired: dict[tuple[str, str], int] = {}
        # RLock, not Lock: allocations inside totals() can trigger cyclic
        # GC, which may run a dead store's finalize (_retire) SYNCHRONOUSLY
        # on this same thread — with a plain lock that self-deadlocks the
        # /metrics scrape
        self._lock = threading.RLock()

    def track(self, store: "ObjectStore") -> None:
        with self._lock:
            self._stores.add(store)
        weakref.finalize(store, self._retire, store.commit_counts)

    def _retire(self, counts: dict) -> None:
        with self._lock:
            for key, n in counts.items():
                self._retired[key] = self._retired.get(key, 0) + n

    def totals(self) -> dict[tuple[str, str], int]:
        with self._lock:
            stores = list(self._stores)
            agg = dict(self._retired)
        for store in stores:
            for key, n in store.commit_counts_snapshot().items():
                agg[key] = agg.get(key, 0) + n
        return agg

    def collect(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        for (kind, site), n in sorted(self.totals().items()):
            out.append(f'{self.name}{{kind="{kind}",site="{site}"}} {n}')
        return out


_COMMITS = _CommitsCollector()
REGISTRY.register(_COMMITS)
REGISTRY.register(ROWS_GAUGE)


class NotFound(KeyError):
    pass


class Conflict(RuntimeError):
    pass


class AlreadyExists(RuntimeError):
    pass


class StoreEvent(NamedTuple):
    """ADDED | MODIFIED | DELETED, like a watch event.

    A NamedTuple, not a dataclass: construction is C-level, and _notify
    builds one per watcher per commit — 135k+ per cold-start tick."""

    type: str
    kind: str
    name: str


def _node_of(obj) -> str | None:
    """The secondary-index key: ``spec.node_name`` where present.

    Reads ``spec.__dict__`` directly instead of ``getattr`` with a
    default: specs are plain (non-slots) dataclasses, and the swallowed
    AttributeError on every BridgeJob commit (whose spec has no
    ``node_name``) was ~2 µs × two calls × 45k commits per cold-start
    sweep."""
    spec = obj.__dict__.get("spec")
    if spec is None:
        return None
    node = spec.__dict__.get("node_name")
    return node if isinstance(node, str) else None


class ObjectStore:
    def __init__(self, *, columnar: tuple[str, ...] | None = None):
        """``columnar`` selects which kinds live in column tables;
        defaults to :data:`bridge.columns.DEFAULT_COLUMNAR`. Pass ``()``
        for the pure frozen-object store (the equivalence oracle)."""
        self._lock = threading.RLock()
        kinds = _columns.DEFAULT_COLUMNAR if columnar is None else tuple(columnar)
        #: kind -> KindTable for the columnar kinds
        self._tables = {k: _columns.make_table(k) for k in kinds}
        #: ``(kind, site) -> commits`` — the per-kind × per-callsite
        #: attribution ledger behind ``sbt_store_commits_total`` and the
        #: flight recorder's commit breakdown. Incremented inline by the
        #: commit paths (a dict add under the already-held store lock);
        #: writers name their callsite via the ``site=`` kwarg, anything
        #: that doesn't lands under "other".
        self.commit_counts: dict[tuple[str, str], int] = {}
        _COMMITS.track(self)
        #: kind -> name -> frozen stored object
        self._by_kind: dict[str, dict[str, object]] = {}
        #: kind -> node_name -> set of names bound there (Pods, mostly)
        self._by_node: dict[str, dict[str, set[str]]] = {}
        #: name-sorted cache per kind / per (kind, node); None = stale.
        #: Updates keep membership, so only create/delete invalidate.
        self._sorted_names: dict[str, list[str] | None] = {}
        self._node_sorted: dict[tuple[str, str], list[str] | None] = {}
        #: monotonic dirty-set: kind -> name -> rv of last create/update,
        #: and the tombstone side: kind -> name -> rv at delete
        self._changed: dict[str, dict[str, int]] = {}
        self._tombstones: dict[str, dict[str, int]] = {}
        #: partitioned dirty-set (ISSUE 19): kind -> writer partition id
        #: -> name -> rv, populated by :meth:`apply_frames` when the
        #: caller names its partition. Keyed lazily — a store that never
        #: sees a partitioned commit carries no extra state, and
        #: ``changes_since`` unions these with the catch-all ``_changed``
        #: so every existing consumer stays correct; the WAL flush reads
        #: the partitions directly via :meth:`changes_since_partitioned`.
        self._dirty_parts: dict[str, dict[int, dict[str, int]]] = {}
        #: per-kind high-water mark: the global rv of the kind's LAST
        #: change or delete. ``changes_since`` answers "nothing moved"
        #: in O(1) off this — the incremental tick (PR-11) probes the
        #: Pod dirty-set several times per tick, and enumerating a 50k-
        #: name dict per probe was most of a steady tick's residual cost
        self._kind_rv: dict[str, int] = {}
        self._rv = 0
        #: SimpleQueue, not Queue: put() is C-implemented and lock-free
        #: on the GIL — _notify runs under the store lock for EVERY
        #: commit, and a cold-start tick delivers 100k+ events per
        #: watcher (Queue.put's mutex+notify was ~5 µs each there).
        #: The tuple snapshot exists so _notify iterates without building
        #: a defensive list copy per commit.
        self._watchers: list[tuple[queue.SimpleQueue, tuple[str, ...] | None]] = []
        self._watchers_snapshot: tuple = ()

    # ---- plumbing ----

    def _key(self, obj) -> tuple[str, str]:
        return (obj.KIND, obj.meta.name)

    def _notify(self, etype: str, kind: str, name: str) -> None:
        for q, kinds in self._watchers_snapshot:
            if kinds is None or kind in kinds:
                q.put(StoreEvent(etype, kind, name))

    def watch(self, kinds: tuple[str, ...] | None = None) -> queue.SimpleQueue:
        """A queue of StoreEvents for the given kinds (None = all).

        New watchers receive synthetic ADDED events for existing objects so
        level-triggered consumers converge from any start time.
        """
        q: queue.SimpleQueue = queue.SimpleQueue()
        with self._lock:
            for kind, objs in self._by_kind.items():
                if kinds is None or kind in kinds:
                    for name in objs:
                        q.put(StoreEvent("ADDED", kind, name))
            for kind, table in self._tables.items():
                if kinds is None or kind in kinds:
                    for name in table.row_of:
                        q.put(StoreEvent("ADDED", kind, name))
            self._watchers.append((q, kinds))
            self._watchers_snapshot = tuple(self._watchers)
        return q

    def unwatch(self, q: queue.SimpleQueue) -> None:
        with self._lock:
            self._watchers = [(w, k) for (w, k) in self._watchers if w is not q]
            self._watchers_snapshot = tuple(self._watchers)

    # ---- index maintenance (call with the lock held) ----

    def _index_add(self, kind: str, name: str, obj) -> None:
        self._index_add_node(kind, name, _node_of(obj))

    def _index_add_node(self, kind: str, name: str, node) -> None:
        if node is not None:
            self._by_node.setdefault(kind, {}).setdefault(node, set()).add(name)
            self._node_sorted[(kind, node)] = None

    def _index_remove(self, kind: str, name: str, obj) -> None:
        self._index_remove_node(kind, name, _node_of(obj))

    def _index_remove_node(self, kind: str, name: str, node) -> None:
        if node is None:
            return
        bucket = self._by_node.get(kind, {}).get(node)
        if bucket is not None:
            bucket.discard(name)
            if not bucket:
                del self._by_node[kind][node]
            self._node_sorted[(kind, node)] = None

    def _index_move(self, kind: str, name: str, old, new) -> None:
        old_node, new_node = _node_of(old), _node_of(new)
        if old_node == new_node:
            return
        self._index_remove(kind, name, old)
        self._index_add(kind, name, new)

    def _record_change(self, kind: str, name: str) -> None:
        self._changed.setdefault(kind, {})[name] = self._rv
        self._kind_rv[kind] = self._rv
        tombs = self._tombstones.get(kind)
        if tombs is not None:
            tombs.pop(name, None)

    # ---- commit attribution ----

    def commit_counts_snapshot(self) -> dict[tuple[str, str], int]:
        """A copy of the commit ledger (small: one entry per kind × site)."""
        with self._lock:
            return dict(self.commit_counts)

    def commits_total(self) -> int:
        with self._lock:
            return sum(self.commit_counts.values())

    def current_rv(self) -> int:
        """The store's global resource-version counter — the watermark
        write-behind consumers (WAL persistence) flush up to."""
        with self._lock:
            return self._rv

    def contains(self, kind: str, name: str) -> bool:
        """Existence probe that builds NO view for columnar kinds (a
        ``try_get`` would materialize one just to throw it away)."""
        with self._lock:
            table = self._tables.get(kind)
            if table is not None:
                return name in table.row_of
            return name in self._by_kind.get(kind, {})

    @staticmethod
    def _span_commits(kind: str, site: str, n: int) -> None:
        """Attribute ``n`` commits to the active sampled span, if any —
        the per-phase spans end up carrying exactly the commits their
        phase caused. One contextvar read when tracing is off."""
        span = current_span()
        if span is not None and span.sampled:
            span.count(f"commits.{kind}.{site}", n)

    #: tombstones kept per kind; beyond this the oldest are compacted away
    #: so a long-running bridge's delete churn doesn't grow memory (and
    #: the changes_since scan) forever. A consumer further than this many
    #: deletions behind misses some tombstones — every in-repo consumer
    #: self-heals (the scheduler's cancel scan drops names whose try_get
    #: misses), same contract as a K8s watch falling off the event horizon.
    TOMBSTONE_LIMIT = 10_000

    def _record_delete(self, kind: str, name: str) -> None:
        self._changed.get(kind, {}).pop(name, None)
        parts = self._dirty_parts.get(kind)
        if parts:
            for pdirty in parts.values():
                pdirty.pop(name, None)
        self._kind_rv[kind] = self._rv
        tombs = self._tombstones.setdefault(kind, {})
        tombs[name] = self._rv
        # compact with 25% slack so the sort amortizes over many deletes
        if len(tombs) > self.TOMBSTONE_LIMIT * 5 // 4:
            for old in sorted(tombs, key=tombs.__getitem__)[
                : len(tombs) - self.TOMBSTONE_LIMIT
            ]:
                del tombs[old]

    # ---- CRUD ----

    def create(self, obj, *, site: str = "other") -> object:
        """Insert ``obj``; the store takes ownership and freezes it in
        place. The returned object IS the stored (frozen) snapshot."""
        with self._lock:
            stored = self._commit_create(obj, site)
        self._span_commits(obj.KIND, site, 1)
        return stored

    def _commit_create(self, obj, site: str = "other") -> object:
        """One insert; caller holds the lock."""
        kind, name = key = self._key(obj)
        table = self._tables.get(kind)
        if table is not None:
            if name in table.row_of:
                raise AlreadyExists(f"{key[0]}/{key[1]} already exists")
            self._rv += 1
            obj.meta.resource_version = self._rv
            freeze(obj)
            row = table.insert(name, obj)
            self._index_add_node(kind, name, table.adapter.node_value(table, row))
        else:
            objs = self._by_kind.setdefault(kind, {})
            if name in objs:
                raise AlreadyExists(f"{key[0]}/{key[1]} already exists")
            self._rv += 1
            obj.meta.resource_version = self._rv
            freeze(obj)
            objs[name] = obj
            self._index_add(kind, name, obj)
        self._sorted_names[kind] = None
        self._record_change(kind, name)
        ckey = (kind, site)
        self.commit_counts[ckey] = self.commit_counts.get(ckey, 0) + 1
        self._notify("ADDED", kind, name)
        return obj

    def create_batch(self, objs: list, *, site: str = "other") -> list:
        """Insert many objects under ONE lock acquisition (the operator
        sweep's sizecar/worker-pod creates — a cold-start tick used to pay
        45k separate lock round-trips here).

        Returns one entry per input, in order: the stored (frozen) object
        on success, or the :class:`AlreadyExists` instance that create
        raised. A failed create never aborts the batch — each object
        stands alone, exactly as if inserted via :meth:`create`.
        """
        out: list = []
        span = current_span()
        committed: dict[str, int] | None = (
            {} if span is not None and span.sampled else None
        )
        with self._lock:
            for obj in objs:
                try:
                    out.append(self._commit_create(obj, site))
                except AlreadyExists as exc:
                    out.append(exc)
                    continue
                if committed is not None:
                    committed[obj.KIND] = committed.get(obj.KIND, 0) + 1
        if committed:
            for kind, n in committed.items():
                span.count(f"commits.{kind}.{site}", n)
        return out

    def get(self, kind: str, name: str) -> object:
        """The current frozen snapshot — shared, zero-copy. To modify,
        use :meth:`mutate` or :meth:`get_for_update`. For columnar kinds
        the snapshot is a lazily-materialized view, cached per resource
        version, so repeated reads share one object exactly like the
        object-backed kinds."""
        with self._lock:
            table = self._tables.get(kind)
            if table is not None:
                row = table.row_of.get(name)
                if row is None:
                    raise NotFound(f"{kind}/{name}")
                return table.view(row)
            try:
                return self._by_kind[kind][name]
            except KeyError:
                raise NotFound(f"{kind}/{name}") from None

    def try_get(self, kind: str, name: str):
        try:
            return self.get(kind, name)
        except NotFound:
            return None

    def count(self, kind: str) -> int:
        """Number of stored objects of ``kind`` — O(1), one lock. Lets
        bulk-read consumers (the operator sweep) decide between per-key
        lookups and a full list() by dirty-set FRACTION, not just size."""
        with self._lock:
            table = self._tables.get(kind)
            if table is not None:
                return len(table.row_of)
            return len(self._by_kind.get(kind, {}))

    def get_for_update(self, kind: str, name: str) -> object:
        """A private, mutable deep copy for read-modify-write callers
        (pass it back through :meth:`update`)."""
        return thaw(self.get(kind, name))

    def update(self, obj, *, site: str = "other") -> object:
        """Replace; raises Conflict if the caller's copy is stale.

        Takes ownership of ``obj`` (freezes it in place) — callers keep
        reading it but can no longer mutate it."""
        with self._lock:
            stored = self._commit_update(obj, site)
        self._span_commits(obj.KIND, site, 1)
        return stored

    def _commit_update(self, obj, site: str = "other") -> object:
        """One optimistic write; caller holds the lock."""
        kind, name = self._key(obj)
        table = self._tables.get(kind)
        if table is not None:
            row = table.row_of.get(name)
            if row is None:
                raise NotFound(f"{kind}/{name}")
            current_rv = int(table.cols.rv[row])
            if current_rv != obj.meta.resource_version:
                raise Conflict(
                    f"{kind}/{name}: stale resource_version "
                    f"{obj.meta.resource_version} != {current_rv}"
                )
            old_node = table.adapter.node_value(table, row)
            self._rv += 1
            obj.meta.resource_version = self._rv
            freeze(obj)
            table.replace(row, obj)
            new_node = table.adapter.node_value(table, row)
            if old_node != new_node:
                self._index_remove_node(kind, name, old_node)
                self._index_add_node(kind, name, new_node)
        else:
            objs = self._by_kind.get(kind, {})
            current = objs.get(name)
            if current is None:
                raise NotFound(f"{kind}/{name}")
            if current.meta.resource_version != obj.meta.resource_version:
                raise Conflict(
                    f"{kind}/{name}: stale resource_version "
                    f"{obj.meta.resource_version} != {current.meta.resource_version}"
                )
            self._rv += 1
            obj.meta.resource_version = self._rv
            freeze(obj)
            objs[name] = obj
            self._index_move(kind, name, current, obj)
        self._record_change(kind, name)
        ckey = (kind, site)
        self.commit_counts[ckey] = self.commit_counts.get(ckey, 0) + 1
        self._notify("MODIFIED", kind, name)
        return obj

    def update_batch(self, objs: list, *, site: str = "other") -> list:
        """Apply many optimistic-concurrency writes under ONE lock
        acquisition (the scheduler's bind path).

        Returns one entry per input, in order: the stored (frozen) object
        on success, or the :class:`Conflict`/:class:`NotFound` instance
        that write raised. A failed write never aborts the batch — each
        object stands alone, exactly as if written via :meth:`update`.
        """
        out: list = []
        span = current_span()
        committed: dict[str, int] | None = (
            {} if span is not None and span.sampled else None
        )
        with self._lock:
            for obj in objs:
                try:
                    out.append(self._commit_update(obj, site))
                except (Conflict, NotFound) as exc:
                    out.append(exc)
                    continue
                if committed is not None:
                    committed[obj.KIND] = committed.get(obj.KIND, 0) + 1
        if committed:
            for kind, n in committed.items():
                span.count(f"commits.{kind}.{site}", n)
        return out

    def delete(self, kind: str, name: str) -> None:
        """Delete an object and cascade transitively through owner refs:
        children, grandchildren, and so on all go (K8s garbage-collector
        semantics — one level was not enough, a BridgeJob→Pod→owned-object
        chain leaked the leaves)."""
        with self._lock:
            table = self._tables.get(kind)
            exists = (
                name in table.row_of
                if table is not None
                else name in self._by_kind.get(kind, {})
            )
            if not exists:
                raise NotFound(f"{kind}/{name}")
            self._delete_one(kind, name)
            frontier = {name}
            while frontier:
                owned = sorted(
                    itertools.chain(
                        (
                            (k, n)
                            for k, kobjs in self._by_kind.items()
                            for n, o in kobjs.items()
                            if getattr(o.meta, "owner", "") in frontier
                        ),
                        *(
                            t.names_owned_by(frontier)
                            for t in self._tables.values()
                        ),
                    )
                )
                frontier = set()
                for okind, oname in owned:
                    self._delete_one(okind, oname)
                    frontier.add(oname)

    def _delete_one(self, kind: str, name: str) -> None:
        table = self._tables.get(kind)
        if table is not None:
            row = table.row_of[name]
            node = table.adapter.node_value(table, row)
            table.release(name)
            self._index_remove_node(kind, name, node)
        else:
            obj = self._by_kind[kind].pop(name)
            self._index_remove(kind, name, obj)
        self._sorted_names[kind] = None
        self._rv += 1
        self._record_delete(kind, name)
        self._notify("DELETED", kind, name)

    # ---- reads over many objects ----

    def _names(self, kind: str) -> list[str]:
        names = self._sorted_names.get(kind)
        if names is None:
            table = self._tables.get(kind)
            source = table.row_of if table is not None else self._by_kind.get(kind, {})
            names = sorted(source)
            self._sorted_names[kind] = names
        return names

    def list(self, kind: str, *, labels: dict[str, str] | None = None) -> list:
        """Name-sorted frozen snapshots of every object of ``kind``."""
        t0 = time.perf_counter()
        with self._lock:
            table = self._tables.get(kind)
            if table is not None:
                row_of = table.row_of
                out = [table.view(row_of[n]) for n in self._names(kind)]
            else:
                objs = self._by_kind.get(kind, {})
                out = [objs[n] for n in self._names(kind)]
        if labels:
            out = [
                o
                for o in out
                if all(o.meta.labels.get(lk) == lv for lk, lv in labels.items())
            ]
        _list_seconds.observe(time.perf_counter() - t0)
        return out

    def list_by_node(self, kind: str, node_name: str) -> list:
        """Name-sorted frozen snapshots of the objects whose
        ``spec.node_name`` equals ``node_name`` — the secondary index that
        lets each virtual-node provider list only ITS pods instead of
        copying the whole store every sync tick."""
        t0 = time.perf_counter()
        with self._lock:
            bucket = self._by_node.get(kind, {}).get(node_name)
            if not bucket:
                _list_seconds.observe(time.perf_counter() - t0)
                return []
            names = self._node_sorted.get((kind, node_name))
            if names is None:
                names = sorted(bucket)
                self._node_sorted[(kind, node_name)] = names
            table = self._tables.get(kind)
            if table is not None:
                row_of = table.row_of
                out = [table.view(row_of[n]) for n in names]
            else:
                objs = self._by_kind.get(kind, {})
                out = [objs[n] for n in names]
        _list_seconds.observe(time.perf_counter() - t0)
        return out

    def owned_by(self, kind: str, owner: str) -> list:
        """Name-sorted (same order as :meth:`list` — reconcilers iterating
        owned sets must be deterministic) frozen snapshots."""
        with self._lock:
            table = self._tables.get(kind)
            if table is not None:
                owner_col = table.cols.owner
                names = sorted(
                    n for n, r in table.row_of.items() if owner_col[r] == owner
                )
                return [table.view(table.row_of[n]) for n in names]
            return sorted(
                (
                    o
                    for o in self._by_kind.get(kind, {}).values()
                    if o.meta.owner == owner
                ),
                key=lambda o: o.meta.name,
            )

    def changes_since(
        self, kind: str, since_rv: int
    ) -> tuple[int, list[str], list[str]]:
        """The per-kind monotonic dirty-set: ``(rv, changed, deleted)``.

        ``changed``/``deleted`` are the name-sorted sets of objects
        created-or-updated / deleted after ``since_rv``; feed the returned
        ``rv`` back in on the next call. ``since_rv=0`` returns everything
        (and every tombstone still remembered), so consumers converge from
        any start point — the watch contract, poll-shaped.
        """
        with self._lock:
            rv = self._rv
            if self._kind_rv.get(kind, 0) <= since_rv:
                # O(1) idle probe: the kind's last change/delete is at or
                # before the caller's cursor — nothing to enumerate
                return rv, [], []
            parts = self._dirty_parts.get(kind)
            if parts:
                names = {
                    n
                    for n, r in self._changed.get(kind, {}).items()
                    if r > since_rv
                }
                for pdirty in parts.values():
                    names.update(
                        n for n, r in pdirty.items() if r > since_rv
                    )
                changed = sorted(names)
            else:
                changed = sorted(
                    n
                    for n, r in self._changed.get(kind, {}).items()
                    if r > since_rv
                )
            deleted = sorted(
                n
                for n, r in self._tombstones.get(kind, {}).items()
                if r > since_rv
            )
        return rv, changed, deleted

    def has_partitioned_dirty(self, kind: str) -> bool:
        """True when ``kind`` has any per-partition dirty records — the
        WAL flush switches to :meth:`changes_since_partitioned` then."""
        with self._lock:
            parts = self._dirty_parts.get(kind)
            return bool(parts) and any(parts.values())

    def changes_since_partitioned(
        self, kind: str, since_rv: int
    ) -> tuple[int, list[str], list[str]]:
        """:meth:`changes_since`, reading the per-partition dirty dicts
        directly (partition-id order) plus the catch-all set — identical
        output by construction, but the flush walks each writer
        partition's own records instead of one global per-kind dict."""
        with self._lock:
            rv = self._rv
            if self._kind_rv.get(kind, 0) <= since_rv:
                return rv, [], []
            names = {
                n
                for n, r in self._changed.get(kind, {}).items()
                if r > since_rv
            }
            for pid in sorted(self._dirty_parts.get(kind, {})):
                names.update(
                    n
                    for n, r in self._dirty_parts[kind][pid].items()
                    if r > since_rv
                )
            deleted = sorted(
                n
                for n, r in self._tombstones.get(kind, {}).items()
                if r > since_rv
            )
        return rv, sorted(names), deleted

    # ---- columnar row access (the PR-6 hot paths) ----

    def table(self, kind: str):
        """The :class:`~bridge.colstore.KindTable` backing ``kind``, or
        None when the kind is object-backed. Consumers that read columns
        directly must hold :meth:`locked` while touching them."""
        return self._tables.get(kind)

    def locked(self):
        """The store lock, for column readers: ``with store.locked():``."""
        return self._lock

    def rows_by_node(self, kind: str, node_name: str) -> tuple[list[str], np.ndarray]:
        """``(names, rows)`` of the node-index bucket, name-sorted — the
        column-level sibling of :meth:`list_by_node` (no views built)."""
        table = self._tables[kind]
        with self._lock:
            bucket = self._by_node.get(kind, {}).get(node_name)
            if not bucket:
                return [], np.empty(0, np.int64)
            names = self._node_sorted.get((kind, node_name))
            if names is None:
                names = sorted(bucket)
                self._node_sorted[(kind, node_name)] = names
            return names, table.rows_for(names)

    def update_rows(
        self,
        kind: str,
        names: list[str],
        expected_rv,
        writer,
        *,
        site: str = "other",
        node_to=None,
    ) -> np.ndarray:
        """Batch optimistic row-commit for a columnar kind.

        Resolves ``names`` → rows under ONE lock acquisition, drops
        entries that vanished (NotFound) or whose row rv moved past
        ``expected_rv`` (Conflict; pass None to skip the check), then
        calls ``writer(rows, sel)`` once — ``rows`` are the surviving row
        indices, ``sel`` their positions in ``names`` — to scatter column
        values. The store does everything :meth:`update_batch` would per
        object: sequential resource versions in caller order, dirty-set
        records, MODIFIED watch events, node-index moves (via
        ``node_to``, an array of new node keys aligned with ``names`` —
        writers must NOT touch the node column themselves), commit
        attribution. View caches invalidate by construction (the rv
        moves past the cached one).

        Returns an int64 array aligned with ``names``: the new rv on
        success, 0 for NotFound, -1 for Conflict.
        """
        table = self._tables[kind]
        n = len(names)
        out = np.zeros(n, np.int64)
        with self._lock:
            rows = table.rows_for(names)
            found = rows >= 0
            ok = found.copy()
            if expected_rv is not None and n:
                cur = table.cols.rv[np.where(found, rows, 0)]
                ok &= cur == np.asarray(expected_rv, np.int64)
            out[found & ~ok] = -1
            sel = np.nonzero(ok)[0]
            if not sel.size:
                return out
            okrows = rows[sel]
            writer(okrows, sel)
            if node_to is not None:
                node_col = table.cols.col(table.adapter.node_col)
                for pos, row in zip(sel.tolist(), okrows.tolist()):
                    old = node_col[row]
                    new = node_to[pos]
                    if old != new:
                        name = names[pos]
                        self._index_remove_node(
                            kind, name, old if isinstance(old, str) else None
                        )
                        self._index_add_node(
                            kind, name, new if isinstance(new, str) else None
                        )
                        node_col[row] = new
            base = self._rv
            new_rvs = base + 1 + np.arange(sel.size, dtype=np.int64)
            table.cols.rv[okrows] = new_rvs
            self._rv = int(base + sel.size)
            out[sel] = new_rvs
            changed = self._changed.setdefault(kind, {})
            tombs = self._tombstones.get(kind)
            names_sel = (
                list(names)
                if sel.size == n
                else [names[p] for p in sel.tolist()]
            )
            changed.update(zip(names_sel, new_rvs.tolist()))
            self._kind_rv[kind] = self._rv
            if tombs:
                for name in names_sel:
                    tombs.pop(name, None)
            # per-queue event order matches the per-name loop (queues are
            # independent); hoisting the watcher filter halves the tail
            for q, kinds in self._watchers_snapshot:
                if kinds is None or kind in kinds:
                    put = q.put
                    for name in names_sel:
                        put(StoreEvent("MODIFIED", kind, name))
            table.rows_written += int(sel.size)
            ckey = (kind, site)
            self.commit_counts[ckey] = self.commit_counts.get(ckey, 0) + int(sel.size)
        self._span_commits(kind, site, int(sel.size))
        return out

    def apply_frames(
        self,
        kind: str,
        parts: list,
        *,
        site: str = "other",
        partition: int | None = None,
    ) -> list[np.ndarray]:
        """The partitioned commit merge (ISSUE 19): scatter pre-built
        writer partitions under ONE short lock, in the deterministic
        order ``parts`` arrives in.

        ``parts`` is a list of ``(names, expected_rv, writer)`` tuples —
        each the per-partition slice of what one :meth:`update_rows` call
        would have committed, with the column values already staged
        outside the lock (a worker-built commit frame, typically). The
        merge applies each part with :meth:`update_rows`'s exact
        bookkeeping — optimistic rv check, sequential resource versions
        in caller order, dirty-set records, MODIFIED watch events, commit
        attribution — all main-thread, so the result is byte-identical to
        the serial column scatter by construction. (Node-index moves are
        not supported here: the status-commit writers never move a pod's
        node; callers that need ``node_to`` use :meth:`update_rows`.)

        ``partition`` names the writer partition whose dirty dict the
        changed names land in; None records into the global per-kind set
        exactly as :meth:`update_rows` does. Returns one rv-result array
        per part, aligned with that part's ``names`` (new rv / 0 NotFound
        / -1 Conflict).

        The merge runs inside a ``store.apply`` child span so the flight
        record attributes it; the commit-site attribution itself lands on
        the CALLER's span, matching :meth:`update_rows`'s posture.
        """
        table = self._tables[kind]
        outs: list[np.ndarray] = []
        total = 0
        with TRACER.span("store.apply") as span:
            with self._lock:
                if partition is None:
                    dirty = self._changed.setdefault(kind, {})
                else:
                    dirty = self._dirty_parts.setdefault(
                        kind, {}
                    ).setdefault(int(partition), {})
                tombs = self._tombstones.get(kind)
                for names, expected_rv, writer in parts:
                    n = len(names)
                    out = np.zeros(n, np.int64)
                    outs.append(out)
                    rows = table.rows_for(names)
                    found = rows >= 0
                    ok = found.copy()
                    if expected_rv is not None and n:
                        cur = table.cols.rv[np.where(found, rows, 0)]
                        ok &= cur == np.asarray(expected_rv, np.int64)
                    out[found & ~ok] = -1
                    sel = np.nonzero(ok)[0]
                    if not sel.size:
                        continue
                    okrows = rows[sel]
                    writer(okrows, sel)
                    base = self._rv
                    new_rvs = base + 1 + np.arange(sel.size, dtype=np.int64)
                    table.cols.rv[okrows] = new_rvs
                    self._rv = int(base + sel.size)
                    out[sel] = new_rvs
                    names_sel = (
                        list(names)
                        if sel.size == n
                        else [names[p] for p in sel.tolist()]
                    )
                    dirty.update(zip(names_sel, new_rvs.tolist()))
                    self._kind_rv[kind] = self._rv
                    if tombs:
                        for name in names_sel:
                            tombs.pop(name, None)
                    for q, kinds in self._watchers_snapshot:
                        if kinds is None or kind in kinds:
                            put = q.put
                            for name in names_sel:
                                put(StoreEvent("MODIFIED", kind, name))
                    table.rows_written += int(sel.size)
                    total += int(sel.size)
                ckey = (kind, site)
                self.commit_counts[ckey] = (
                    self.commit_counts.get(ckey, 0) + total
                )
            span.count("parts", len(parts))
            span.count("rows", total)
        if total:
            _frames_applied.inc(total)
        self._span_commits(kind, site, total)
        return outs

    def create_rows(
        self, kind: str, names: list[str], builder, *, site: str = "other"
    ) -> np.ndarray:
        """Batch row-insert for a columnar kind (:meth:`create_batch`'s
        row-level sibling). Names already present are skipped
        (AlreadyExists semantics, 0 in the result); ``builder(rows,
        sel)`` must fill EVERY schema column for the fresh rows
        (segments via the adapter's heaps) except ``rv``, which the
        store assigns. Returns new rv per name (0 = already existed)."""
        table = self._tables[kind]
        n = len(names)
        out = np.zeros(n, np.int64)
        with self._lock:
            row_of = table.row_of
            sel_list: list[int] = []
            fresh: list[str] = []
            seen: set[str] = set()
            for i, name in enumerate(names):
                if name in row_of or name in seen:
                    continue
                seen.add(name)
                sel_list.append(i)
                fresh.append(name)
            if not sel_list:
                return out
            sel = np.asarray(sel_list, np.int64)
            rows = table.alloc_bulk(fresh)
            row_list = rows.tolist()
            builder(rows, sel)
            base = self._rv
            new_rvs = base + 1 + np.arange(sel.size, dtype=np.int64)
            table.cols.rv[rows] = new_rvs
            self._rv = int(base + sel.size)
            out[sel] = new_rvs
            self._sorted_names[kind] = None
            changed = self._changed.setdefault(kind, {})
            tombs = self._tombstones.get(kind)
            adapter = table.adapter
            names_sel = [names[p] for p in sel_list]
            for name, row in zip(names_sel, row_list):
                self._index_add_node(kind, name, adapter.node_value(table, row))
            changed.update(zip(names_sel, new_rvs.tolist()))
            self._kind_rv[kind] = self._rv
            if tombs:
                for name in names_sel:
                    tombs.pop(name, None)
            for q, kinds in self._watchers_snapshot:
                if kinds is None or kind in kinds:
                    put = q.put
                    for name in names_sel:
                        put(StoreEvent("ADDED", kind, name))
            table.rows_written += int(sel.size)
            ckey = (kind, site)
            self.commit_counts[ckey] = self.commit_counts.get(ckey, 0) + int(sel.size)
        self._span_commits(kind, site, int(sel.size))
        return out

    def view_builds_total(self) -> int:
        """Frozen views materialized across columnar kinds — the
        view-materialization pressure diagnostic (``decoded_views_total``
        in the sim headline)."""
        return sum(t.view_builds for t in self._tables.values())

    def rows_written_total(self) -> int:
        """Commits that went through the columnar row path."""
        return sum(t.rows_written for t in self._tables.values())

    # ---- convenience used by reconcilers ----

    def mutate(self, kind: str, name: str, fn, *, retries: int = 8,
               site: str = "other"):
        """Read-modify-write with conflict retry; fn mutates a private
        thawed copy in place and may return False to skip the write."""
        for _ in range(retries):
            snapshot = self.get(kind, name)
            obj = thaw(snapshot)
            if fn(obj) is False:
                return snapshot
            try:
                return self.update(obj, site=site)
            except Conflict:
                continue
        raise Conflict(f"{kind}/{name}: too many conflicts")

    def replace_update(self, kind: str, name: str, build, *, retries: int = 8,
                       site: str = "other"):
        """Optimistic write without the deep copy: ``build(snapshot)``
        returns a REPLACEMENT object (``dataclasses.replace``-style,
        structurally sharing the snapshot's frozen sub-objects) or None to
        skip the write. The hot write paths (status mirror, bind) ride
        this instead of :meth:`mutate` — no thaw, no deepcopy, unchanged
        children shared between versions."""
        for _ in range(retries):
            snapshot = self.get(kind, name)
            obj = build(snapshot)
            if obj is None:
                return snapshot
            try:
                return self.update(obj, site=site)
            except Conflict:
                continue
        raise Conflict(f"{kind}/{name}: too many conflicts")
