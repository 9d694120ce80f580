"""Durable store state — the etcd the standalone bridge doesn't have.

Reference parity (SURVEY.md §5 "Checkpoint/resume"): the reference keeps
its durable state in the K8s API server — CR status, and the jobid label
written at submit time, which is the resume token letting any restarted
component re-associate pods with running Slurm jobs. The standalone
bridge's ObjectStore is in-process, so without persistence a bridge
restart would orphan every running job.

Durability model (the PR-7 rework — the old module rewrote the ENTIRE
store as one JSON dump on any change):

- **Write-ahead log**: every flush appends only what moved since the
  last flush, read straight off the store's per-kind ``changes_since``
  dirty-sets. Records are length-prefixed and CRC32-checksummed
  (``<u32 len><u32 crc><json payload>``), so replay detects a torn tail
  (crash mid-append) or a corrupt record and keeps everything before it.
  Since PR-10 a flush writes ONE framed *batch envelope* (``op:
  "batch"``) carrying all its per-object records, zlib-deflated past a
  size floor (the length word's high bit marks compression) — the 50k
  cold tick's ~135k-record blob frames once and shrinks several-fold
  before the device fsync. Replay expands envelopes inline
  (:func:`iter_wal_records`); pre-batching WALs replay unchanged.
- **Snapshot compaction**: once the WAL grows past a byte/record budget
  (or on :meth:`StorePersistence.compact`), the full store is dumped to
  the snapshot file (atomic tmp+rename) and the WAL truncated. Each
  persistence instance stamps an ``incarnation`` id into its records and
  snapshots, so a crash BETWEEN snapshot install and WAL truncate can
  never replay a previous incarnation's records over the new snapshot.
- **Recovery** (:func:`load_into`): load the snapshot, then replay the
  WAL in order — ``put`` records upsert, ``del`` records delete; records
  already folded into the snapshot (same incarnation, rv ≤ snapshot rv)
  are skipped. A restarted bridge finds its pods, reads their
  ``job_ids``, and the ordinary level-triggered sync re-converges
  against live Slurm state — the same resume-by-label mechanism, one
  directory instead of etcd.
- **Columnar-aware serialization**: ``Pod``/``BridgeJob`` rows are
  dumped straight from the column tables (:mod:`bridge.columns` schema)
  without materializing frozen views, so a flush never fights the PR-6
  ``steady_views == 0`` discipline; and a flush with an empty dirty-set
  writes NOTHING — zero file I/O, zero views (`make bench-smoke`
  asserts both).

Serialization is type-driven both ways: ``asdict``-shaped encoding with
datetime/enum tagging out, the config codec's dataclass decoder (tuples,
nested dataclasses, Optionals) back in.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import logging
import os
import threading
import uuid
from datetime import datetime

from slurm_bridge_tpu_torch.bridge.store import (
    AlreadyExists,
    Conflict,
    NotFound,
    ObjectStore,
)

# the CRC-framed record/replay machinery is shared with the agent's
# job-state journal (PR-8): utils/wal.py owns framing, torn/corrupt
# tolerant parsing, group-commit fsync and the disk-latency seam.
# pack_record/read_wal stay importable from here (the public surface
# tests and docs reference).
from slurm_bridge_tpu_torch.utils.wal import (  # noqa: F401 - re-exported
    RECORD_HDR as _HDR,
    WalWriter,
    durable_fsync,
    frame_body,
    pack_record,
    read_wal,
)

log = logging.getLogger("sbt.persist")

_DT_KEY = "__dt__"


_KIND_REGISTRY: dict[str, type] | None = None


def _kind_registry() -> dict[str, type]:
    # memoized: the pump folds every store event through a registry
    # membership probe, so this sits on the watch fan-out path
    global _KIND_REGISTRY
    if _KIND_REGISTRY is None:
        from slurm_bridge_tpu_torch.bridge.objects import (
            BridgeJob,
            FetchJob,
            Pod,
            PolicyState,
            VirtualNode,
        )

        _KIND_REGISTRY = {
            cls.KIND: cls
            for cls in (BridgeJob, Pod, VirtualNode, FetchJob, PolicyState)
        }
    return _KIND_REGISTRY


def _encode(value):
    if isinstance(value, datetime):
        return {_DT_KEY: value.isoformat()}
    if isinstance(value, enum.Enum):
        return value.value
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _encode(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, (list, tuple)):
        return [_encode(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _encode(v) for k, v in value.items()}
    return value


def _decode(value, ftype):
    import types
    import typing

    origin = typing.get_origin(ftype)
    if isinstance(value, dict) and _DT_KEY in value:
        return datetime.fromisoformat(value[_DT_KEY])
    if isinstance(ftype, type) and issubclass(ftype, enum.Enum):
        return ftype(value)
    if dataclasses.is_dataclass(ftype):
        return _decode_dataclass(value, ftype)
    if origin in (list, tuple) and isinstance(value, list):
        args = typing.get_args(ftype)
        inner = args[0] if args else typing.Any
        seq = [_decode(v, inner) for v in value]
        return tuple(seq) if origin is tuple else seq
    if origin is dict and isinstance(value, dict):
        args = typing.get_args(ftype)
        vt = args[1] if len(args) == 2 else typing.Any
        return {k: _decode(v, vt) for k, v in value.items()}
    if origin in (typing.Union, types.UnionType):
        for arg in typing.get_args(ftype):
            if arg is type(None):
                if value is None:
                    return None
                continue
            try:
                return _decode(value, arg)
            except (TypeError, ValueError):
                continue
        return value
    return value


# -- compiled decoders -------------------------------------------------
#
# Recovery at the headline shape replays ~100k objects, each fanning out
# into nested dataclasses/enums/unions. The generic ``_decode`` pays the
# full type-dispatch cascade (get_origin/is_dataclass/issubclass) for
# EVERY value, and ``typing.get_type_hints`` re-evaluated annotations per
# object — together they dominated the whole snapshot reload. Type hints
# are immutable per class, so each hint compiles ONCE into a closure;
# ``_decode`` stays as the semantics-defining fallback (the closures must
# decode exactly like it — the round-trip tests hold the two together).

_DECODERS: dict[object, object] = {}


def _decoder_for(ftype):
    try:
        cached = _DECODERS.get(ftype)
    except TypeError:  # unhashable hint: fall back to the generic path
        return lambda v, _t=ftype: _decode(v, _t)
    if cached is None:
        cached = _build_decoder(ftype)
        _DECODERS[ftype] = cached
    return cached


def _build_decoder(ftype):
    import types
    import typing

    origin = typing.get_origin(ftype)
    if ftype is datetime:
        def dec_dt(v):
            if isinstance(v, dict) and _DT_KEY in v:
                return datetime.fromisoformat(v[_DT_KEY])
            return v

        return dec_dt
    if isinstance(ftype, type) and issubclass(ftype, enum.Enum):
        return ftype
    if dataclasses.is_dataclass(ftype):
        return lambda v, _cls=ftype: _decode_dataclass(v, _cls)
    if origin in (list, tuple):
        args = typing.get_args(ftype)
        inner = _decoder_for(args[0] if args else typing.Any)
        as_tuple = origin is tuple

        def dec_seq(v, _inner=inner, _tuple=as_tuple):
            if not isinstance(v, list):
                return v
            seq = [_inner(x) for x in v]
            return tuple(seq) if _tuple else seq

        return dec_seq
    if origin is dict:
        args = typing.get_args(ftype)
        vt = _decoder_for(args[1] if len(args) == 2 else typing.Any)

        def dec_map(v, _vt=vt):
            if not isinstance(v, dict):
                return v
            return {k: _vt(x) for k, x in v.items()}

        return dec_map
    if origin in (typing.Union, types.UnionType):
        arms = [
            (arg, _decoder_for(arg))
            for arg in typing.get_args(ftype)
            if arg is not type(None)
        ]
        nullable = type(None) in typing.get_args(ftype)

        def dec_union(v, _arms=tuple(arms), _nullable=nullable):
            if v is None and _nullable:
                return None
            for _, dec in _arms:
                try:
                    return dec(v)
                except (TypeError, ValueError, KeyError):
                    continue
            return v

        return dec_union

    # plain/unknown type (str/int/float/Any/...): values pass through,
    # except the tagged-datetime sentinel the generic path honors for any
    # value shape
    def dec_plain(v):
        if isinstance(v, dict) and _DT_KEY in v:
            return datetime.fromisoformat(v[_DT_KEY])
        return v

    return dec_plain


#: per-class (field name, compiled decoder) pairs, built once
_FIELD_DECODERS: dict[type, tuple[tuple[str, object], ...]] = {}


def _decode_dataclass(raw: dict, cls):
    plan = _FIELD_DECODERS.get(cls)
    if plan is None:
        import typing

        hints = typing.get_type_hints(cls)
        plan = tuple(
            (f.name, _decoder_for(hints.get(f.name, typing.Any)))
            for f in dataclasses.fields(cls)
        )
        _FIELD_DECODERS[cls] = plan
    kwargs = {}
    for name, dec in plan:
        if name in raw:
            kwargs[name] = dec(raw[name])
    return cls(**kwargs)


# -------------------------------------------------- columnar row → doc

def _dt_doc(dt: datetime | None):
    return None if dt is None else {_DT_KEY: dt.isoformat()}


def _meta_doc(c, row: int) -> dict:
    return {
        "name": c.name[row],
        "uid": c.uid[row],
        "labels": _encode(c.labels[row]),
        "annotations": _encode(c.ann[row]),
        "owner": c.owner[row],
        "resource_version": int(c.rv[row]),
        "deleted": bool(c.deleted[row]),
    }


def _pod_row_doc(table, row: int) -> dict:
    """A Pod row as the snapshot/WAL document — field-for-field what
    ``_encode(table.view(row))`` would produce, built straight from
    columns so the flush materializes ZERO frozen views."""
    from slurm_bridge_tpu_torch.bridge.columns import PHASE_STRS, heap_dt

    c = table.cols
    a = table.adapter
    h = a.infos
    istart, ilen = int(c.istart[row]), int(c.ilen[row])
    infos = []
    for i in range(istart, istart + ilen):
        infos.append({
            "id": int(h.id[i]),
            "user_id": h.user_id[i],
            "name": h.name[i],
            "exit_code": h.exit_code[i],
            "state": int(h.state[i]),
            "submit_time": _dt_doc(heap_dt(h, "submit", i)),
            "start_time": _dt_doc(heap_dt(h, "start", i)),
            "run_time_s": int(h.run_time[i]),
            "time_limit_s": int(h.limit[i]),
            "working_dir": h.workdir[i],
            "std_out": h.stdout[i],
            "std_err": h.stderr[i],
            "partition": h.partition[i],
            "node_list": h.nodelist[i],
            "batch_host": h.batch_host[i],
            "num_nodes": int(h.num_nodes[i]),
            "array_id": h.array_id[i],
            "reason": h.reason[i],
        })
    ch = a.containers
    cstart, clen = int(c.cstart[row]), int(c.clen[row])
    conts = [
        {
            "name": ch.cname[i],
            "state": ch.cstate[i],
            "exit_code": int(ch.cexit[i]),
            "reason": ch.creason[i],
        }
        for i in range(cstart, cstart + clen)
    ]
    return {
        "meta": _meta_doc(c, row),
        "spec": {
            "role": c.role[row],
            "partition": c.partition[row],
            "demand": _encode(c.demand[row]),
            "node_name": c.node[row],
            "placement_hint": _encode(c.hint[row]),
        },
        "status": {
            "phase": PHASE_STRS[c.phase[row]],
            "reason": c.reason[row],
            "job_ids": _encode(c.job_ids[row]),
            "job_infos": infos,
            "containers": conts,
        },
    }


def _job_row_doc(table, row: int) -> dict:
    """A BridgeJob row as the snapshot/WAL document (no views built)."""
    from slurm_bridge_tpu_torch.bridge.columns import STATE_STRS

    c = table.cols
    h = table.adapter.subjobs
    start, n = int(c.sstart[row]), int(c.slen[row])
    keys = c.skeys[row] or ()
    subjobs = {}
    for k in range(n):
        i = start + k
        subjobs[keys[k]] = {
            "id": int(h.id[i]),
            "array_id": h.array_id[i],
            "state": int(h.state[i]),
            "exit_code": h.exit_code[i],
            "submit_time": h.submit[i],
            "start_time": h.start[i],
            "run_time_s": int(h.run_time[i]),
            "std_out": h.stdout[i],
            "std_err": h.stderr[i],
            "reason": h.reason[i],
        }
    return {
        "meta": _meta_doc(c, row),
        "spec": _encode(c.spec[row]),
        "status": {
            "state": STATE_STRS[c.state[row]],
            "reason": c.reason[row],
            "subjobs": subjobs,
            "fetch_result": c.fetch[row],
            "cluster_endpoint": c.endpoint[row],
        },
    }


def _row_doc_builder(kind: str):
    from slurm_bridge_tpu_torch.bridge.objects import BridgeJob, Pod

    return {Pod.KIND: _pod_row_doc, BridgeJob.KIND: _job_row_doc}.get(kind)


class StorePersistence:
    """WAL-backed write-behind durability for an ObjectStore.

    Every store event schedules a flush ``debounce`` seconds out
    (coalescing bursts); a flush appends only the objects whose
    ``changes_since`` resource_version moved past the last flush — an
    idle store flushes NOTHING (no file write, no frozen views).
    ``close()`` flushes and compacts synchronously, leaving the snapshot
    file complete and the WAL empty.

    Embedders that need deterministic, single-threaded behavior (the sim
    harness) pass ``auto_flush=False`` and drive :meth:`flush` /
    :meth:`compact` themselves — no pump thread, no timers.
    """

    def __init__(
        self,
        store: ObjectStore,
        path: str,
        *,
        debounce: float = 0.2,
        auto_flush: bool = True,
        compact_bytes: int = 4 << 20,
        compact_records: int = 50_000,
        fsync: bool = True,
        fsync_delay_s: float | None = None,
        batch: bool = True,
        compress: bool = True,
        compress_floor: int = 4096,
    ):
        self.store = store
        self.path = path
        self.wal_path = path + ".wal"
        self.debounce = debounce
        self.compact_bytes = compact_bytes
        self.compact_records = compact_records
        self.fsync = fsync
        #: simulated device latency per fsync (None = the process-wide
        #: utils.wal seam) — the fsync-realism bench knob
        self.fsync_delay_s = fsync_delay_s
        #: record batching (PR-10, the ROADMAP durability leftover): one
        #: framed BATCH record per flush instead of one frame per object
        #: — the 50k cold tick's ~135k records become a handful of batch
        #: envelopes, dropping per-record header+parse overhead, and
        #: ``compress`` deflates any batch over ``compress_floor`` bytes
        #: (zlib level 1) so the one-blob flush a slow disk actually
        #: fsyncs is several times smaller. Replay-compatible both ways:
        #: a batch expands inline in :func:`load_into`, and un-batched
        #: records (pre-PR-10 WALs, ``batch=False`` writers) replay
        #: exactly as before.
        self.batch = batch
        self.compress = compress
        self.compress_floor = compress_floor
        self._wal = WalWriter(
            self.wal_path, fsync=fsync, fsync_delay_s=fsync_delay_s
        )
        #: stamped into every record + snapshot; replay refuses to apply
        #: another incarnation's WAL records over this one's snapshot
        self.incarnation = uuid.uuid4().hex
        #: flush watermark: the store rv everything ≤ is already durable
        self._last_rv = 0
        #: observability: record/byte/snapshot counters for gates + tests
        #: (``wal_records``/``wal_bytes`` reset at compaction; the
        #: ``*_total`` forms are cumulative for the instance's lifetime)
        self.wal_records = 0
        self.wal_records_total = 0
        self.snapshots_written = 0
        self.wal_bytes = self._wal.size
        #: batch envelopes appended + pre-compression byte volume — the
        #: on-disk wal_bytes vs wal_bytes_raw ratio is the compression win
        self.wal_batches = 0
        self.wal_bytes_raw = 0
        self._lock = threading.Lock()
        # Serializes whole flush/compact cycles: a timer-fired flush can
        # race close()'s synchronous flush, and two writers interleaving
        # on the same WAL tail (or the snapshot .tmp) would corrupt it.
        self._flush_lock = threading.Lock()
        self._timer: threading.Timer | None = None
        self._stop = threading.Event()
        #: delete tracking rides a dedicated watch, NOT the store's
        #: tombstone map: tombstones are capacity-bounded
        #: (ObjectStore.TOMBSTONE_LIMIT) and a delete burst bigger than
        #: the limit between two flushes would silently lose "del"
        #: records — replay would then resurrect the lost objects from
        #: their earlier "put" records. Watch events are exact and
        #: unbounded; names later recreated are skipped at emit time
        #: (their fresh "put" covers them).
        self._del_watch = store.watch(None)
        self._pending_dels: set[tuple[str, str]] = set()
        self._pump = None
        if auto_flush:
            self._pump = threading.Thread(target=self._run, name="persist", daemon=True)
            self._pump.start()

    def _run(self) -> None:
        # the delete watch doubles as the flush trigger — it already sees
        # every store event, and a second watch(None) would put one more
        # queue on the per-commit fan-out under the store lock
        while not self._stop.is_set():
            try:
                ev = self._del_watch.get(timeout=0.2)
            except Exception:
                continue
            self._fold_event(ev)
            with self._lock:
                if self._timer is None:
                    self._timer = threading.Timer(self.debounce, self.flush)
                    self._timer.daemon = True
                    self._timer.start()

    # ---- serialization ----

    def _fold_event(self, ev) -> None:
        """Fold one watch event into the pending-delete set (persisted
        kinds only). Called from both the pump thread and flush/compact
        drains, hence the lock."""
        if ev.type == "DELETED" and ev.kind in _kind_registry():
            with self._lock:
                self._pending_dels.add((ev.kind, ev.name))

    def _drain_deletes(self) -> None:
        """Fold everything still queued on the watch into the pending
        set (the pump consumes the same queue concurrently in auto-flush
        mode; either consumer folding an event is equivalent)."""
        while True:
            try:
                ev = self._del_watch.get_nowait()
            except Exception:
                break
            self._fold_event(ev)

    def _kind_docs(self, kind: str, names) -> list[tuple[str, dict]]:
        """``(name, doc)`` for the surviving names of one kind. Columnar
        kinds dump straight from rows (zero frozen views) under ONE lock
        acquisition for the whole batch — a 50k-name flush must not pay
        50k lock round-trips against live control loops; object kinds
        are low-churn (VirtualNode/FetchJob) and ride plain ``try_get``."""
        table = self.store.table(kind)
        if table is not None:
            builder = _row_doc_builder(kind)
            out = []
            with self.store.locked():
                row_of = table.row_of
                for name in names:
                    row = row_of.get(name)
                    if row is None:
                        continue  # deleted mid-scan; its del event is coming
                    out.append((
                        name,
                        builder(table, row)
                        if builder is not None
                        else _encode(table.view(row)),
                    ))
            return out
        docs = []
        for name in names:
            obj = self.store.try_get(kind, name)
            if obj is not None:
                docs.append((name, _encode(obj)))
        return docs

    # ---- the write paths ----

    def flush(self) -> int:
        """Append everything that changed since the last flush to the
        WAL; returns the number of records written (0 = nothing dirty —
        no file touched, no views built). Triggers compaction when the
        WAL outgrows its budget."""
        with self._lock:
            self._timer = None
        with self._flush_lock:
            return self._flush_locked()

    def _flush_locked(self) -> int:
        # deletes FIRST, watermark SECOND: every delete captured below
        # committed before ``current_rv()`` runs, so stamping its "del"
        # record with start_rv can never understate the delete's real rv
        # — an understated stamp would fall under the snapshot-rv skip
        # on replay and resurrect the object. Puts are safe the other
        # way around: anything committing while we scan lands above the
        # watermark and is re-emitted next flush (duplicates are
        # idempotent on replay; a gap would be data loss).
        self._drain_deletes()
        with self._lock:
            pending = sorted(self._pending_dels)
        start_rv = self.store.current_rv()
        items: list[dict] = []
        for kind in _kind_registry():
            # partitioned dirty-set (ISSUE 19): when frame commits have
            # recorded per-writer-partition dirty ranges for this kind,
            # read them directly (identical output, and the flush walks
            # each partition's own records). The O(1) no-change probe is
            # shared by both arms, so an idle flush stays zero-I/O.
            cs = (
                self.store.changes_since_partitioned
                if self.store.has_partitioned_dirty(kind)
                else self.store.changes_since
            )
            rv, changed, _ = cs(kind, self._last_rv)
            for name, doc in self._kind_docs(kind, changed):
                items.append({
                    "op": "put",
                    "kind": kind,
                    "name": name,
                    "rv": int(doc.get("meta", {}).get("resource_version", 0)),
                    "object": doc,
                })
        for kind, name in pending:
            if self.store.contains(kind, name):
                continue  # recreated since: its fresh "put" covers it
            # stamped with the flush watermark so the same-incarnation
            # snapshot-rv skip applies to deletes exactly like puts (a
            # crash between snapshot install and WAL truncate must not
            # replay this delete over a newer snapshot's recreation)
            items.append({
                "op": "del",
                "kind": kind,
                "name": name,
                "rv": start_rv,
            })
        n = len(items)
        if not items:
            with self._lock:
                self._pending_dels.difference_update(pending)
            self._last_rv = max(self._last_rv, start_rv)
            return 0
        if self.batch:
            # ONE framed envelope per flush; the incarnation stamp lives
            # on the envelope and covers every inner record on replay
            body = json.dumps(
                {
                    "op": "batch",
                    "inc": self.incarnation,
                    "count": n,
                    "records": items,
                },
                separators=(",", ":"),
            ).encode()
            self.wal_bytes_raw += len(body)
            blob = frame_body(
                body,
                compress=self.compress and len(body) >= self.compress_floor,
            )
            self.wal_batches += 1
        else:
            chunks = [
                pack_record({**it, "inc": self.incarnation}) for it in items
            ]
            blob = b"".join(chunks)
            self.wal_bytes_raw += len(blob)
        # one ordered append + one group-commit barrier for the whole
        # flush — concurrent flushers (debounce timer vs close()) share
        # a single device fsync through the WalWriter
        self._wal.append_durable(blob)
        # only the captured deletes are retired — ones folded while we
        # wrote ride to the next flush (a failed write retires nothing)
        with self._lock:
            self._pending_dels.difference_update(pending)
        self._last_rv = max(self._last_rv, start_rv)
        self.wal_records += n
        self.wal_records_total += n
        self.wal_bytes += len(blob)
        log.debug("WAL: appended %d records (%d bytes) to %s", n, len(blob), self.wal_path)
        if self.wal_bytes > self.compact_bytes or self.wal_records > self.compact_records:
            self._compact_locked()
        return n

    def compact(self) -> None:
        """Fold the WAL into a fresh full snapshot (atomic tmp+rename)
        and truncate the WAL. Also the rebase step after recovery: a
        restarted bridge compacts first so its new-incarnation records
        never mix with the previous process's tail."""
        with self._flush_lock:
            self._compact_locked()

    def _compact_locked(self) -> None:
        start_rv = self.store.current_rv()
        # deletions up to here are reflected in the snapshot itself —
        # the pending "del" set rides the truncated WAL into oblivion
        self._drain_deletes()
        with self._lock:
            self._pending_dels.clear()
        docs = []
        for kind in _kind_registry():
            table = self.store.table(kind)
            if table is not None:
                builder = _row_doc_builder(kind)
                with self.store.locked():
                    for name in sorted(table.row_of):
                        row = table.row_of[name]
                        doc = (
                            builder(table, row)
                            if builder is not None
                            else _encode(table.view(row))
                        )
                        docs.append({"kind": kind, "object": doc})
            else:
                for obj in self.store.list(kind):
                    docs.append({"kind": kind, "object": _encode(obj)})
        tmp = f"{self.path}.tmp"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(
                {
                    "version": 2,
                    "rv": start_rv,
                    "incarnation": self.incarnation,
                    "objects": docs,
                },
                f,
            )
            f.flush()
            durable_fsync(f.fileno(), delay_s=self.fsync_delay_s)
        os.replace(tmp, self.path)
        # snapshot is durable; now the WAL prefix it folded in can go.
        # (A crash between the two replays an incarnation-matched WAL
        # whose rv ≤ snapshot rv records are skipped — no stale rewind.)
        self._wal.truncate()
        self._last_rv = max(self._last_rv, start_rv)
        self.wal_records = 0
        self.wal_bytes = 0
        self.snapshots_written += 1
        log.debug("compacted %d objects into %s", len(docs), self.path)

    def abandon(self) -> None:
        """Release resources WITHOUT flushing — the simulated-crash path
        (the whole point is that nothing gets a last-gasp write). Closes
        the WAL file handle and detaches the store watch; the instance
        must not be used afterwards."""
        if self._pump is not None:
            self._stop.set()
            self._pump.join(5.0)
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
        self._wal.close()
        self.store.unwatch(self._del_watch)

    def close(self) -> None:
        if self._pump is not None:
            self._stop.set()
            self._pump.join(5.0)
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
        with self._flush_lock:
            self._flush_locked()
            self._compact_locked()
            self._wal.close()
        self.store.unwatch(self._del_watch)


# ------------------------------------------------------------ recovery

def iter_wal_records(records):
    """Flatten batch envelopes (PR-10) into the plain per-object record
    stream replay has always consumed. Inner records inherit the
    envelope's incarnation stamp; non-batch records (pre-batching WALs,
    ``batch=False`` writers) pass through untouched — both formats
    replay through one loop."""
    for rec in records:
        if rec.get("op") == "batch":
            inc = rec.get("inc")
            for inner in rec.get("records", ()):
                if inc is not None and "inc" not in inner:
                    inner = {**inner, "inc": inc}
                yield inner
        else:
            yield rec


def _apply_put(store: ObjectStore, cls, doc: dict) -> bool:
    obj = _decode_dataclass(doc, cls)
    try:
        current = store.get(cls.KIND, obj.meta.name)
    except NotFound:
        try:
            store.create(obj, site="persist.replay")
            return True
        except AlreadyExists:
            return False
    obj.meta.resource_version = current.meta.resource_version
    try:
        store.update(obj, site="persist.replay")
        return True
    except (Conflict, NotFound):
        return False


def load_into(store: ObjectStore, path: str) -> int:
    """Restore snapshot + WAL into an (empty) store; returns the number
    of live objects restored.

    ``meta.resource_version`` restarts from the store's own counter — the
    optimistic-concurrency tokens only need to be consistent within one
    process lifetime (same as informer caches resyncing from scratch).
    WAL replay is level-triggered: ``put`` upserts, ``del`` deletes (the
    cascade mirrors what the live store already did); a torn tail or a
    checksum-corrupt record stops replay there with a warning — state up
    to the defect survives.
    """
    registry = _kind_registry()
    snap_rv = 0
    snap_inc = None
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
        snap_rv = int(data.get("rv", 0))
        snap_inc = data.get("incarnation")
        for doc in data.get("objects", []):
            cls = registry.get(doc.get("kind"))
            if cls is None:
                log.warning("snapshot has unknown kind %r; skipped", doc.get("kind"))
                continue
            try:
                store.create(_decode_dataclass(doc["object"], cls), site="persist.replay")
            except Exception:
                log.exception("failed to restore a %s object", doc.get("kind"))

    records, _, defect = read_wal(path + ".wal")
    if defect is not None:
        log.warning(
            "WAL %s.wal has a %s tail; replaying the %d clean records before it",
            path, defect, len(records),
        )
    for rec in iter_wal_records(records):
        if snap_inc is not None and rec.get("inc") not in (None, snap_inc):
            # another incarnation's leftover tail (crash between snapshot
            # install and WAL truncate): already folded into the snapshot
            continue
        if rec.get("inc") == snap_inc and int(rec.get("rv", 0)) <= snap_rv:
            # already folded into the snapshot — puts AND deletes (a
            # delete replayed over a later same-name recreation in the
            # snapshot would cascade-erase live state)
            continue
        cls = registry.get(rec.get("kind"))
        if cls is None:
            log.warning("WAL record has unknown kind %r; skipped", rec.get("kind"))
            continue
        try:
            if rec.get("op") == "del":
                try:
                    store.delete(cls.KIND, rec["name"])
                except NotFound:
                    pass
            else:
                _apply_put(store, cls, rec["object"])
        except Exception:
            log.exception("failed to replay a %s WAL record", rec.get("kind"))
    return sum(store.count(kind) for kind in registry)
