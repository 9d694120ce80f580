"""Columnar schemas for the hot store kinds — Pod and BridgeJob.

This module declares WHAT is columnar (:data:`DEFAULT_COLUMNAR`), the
code tables that turn enum-ish strings into int8 columns, and the two
kind adapters that translate between frozen dataclass objects and rows:

- **Pod** — meta/spec/status scalars as columns; ``status.job_infos``
  lives in a :class:`~bridge.colstore.SegmentHeap` of JobInfo rows (all
  18 fields columnar, timestamps carried twice: the exact object for
  view materialization and an epoch-seconds column for vectorized
  diffs); ``status.containers`` in a second heap.
- **BridgeJob** — same shape; ``status.subjobs`` is a SubjobStatus heap
  plus a per-row key tuple preserving insertion order.

The adapters keep the store's read contract exact: ``materialize``
rebuilds a frozen dataclass view that compares equal (``==``, field for
field, resource_version included) to what the object-based store would
hand out, sharing the frozen sub-objects (spec, labels, demand) that
were stored by reference. ``decompose`` is the inverse, used by the
generic create/update paths; the hot paths skip it entirely and write
columns directly through :meth:`ObjectStore.update_rows`.

Vectorized derivations used by the mirror and sweep live here too:
single-status pod-phase (:data:`PHASE_OF_SINGLE_STATE`), phase→CR-state
(:data:`CR_STATE_OF_PHASE`), and the proto→column decode
(:class:`InfoScratch`) that fills JobInfo columns straight from a
``JobsInfoResponse`` without building a single intermediate dataclass.
"""

from __future__ import annotations

from datetime import datetime, timezone

import numpy as np

from slurm_bridge_tpu_torch.bridge.colstore import ColumnBlock, KindTable, SegmentHeap
from slurm_bridge_tpu_torch.bridge.freeze import FrozenDict, FrozenList
from slurm_bridge_tpu_torch.bridge.objects import (
    BridgeJob,
    BridgeJobStatus,
    ContainerStatus,
    JobState,
    Meta,
    Pod,
    PodPhase,
    PodSpec,
    PodStatus,
    SubjobStatus,
)
from slurm_bridge_tpu_torch.bridge.statusmap import pod_phase_for
from slurm_bridge_tpu_torch.core.fastpath import FROZEN_FLAG, enable_guard
from slurm_bridge_tpu_torch.core.types import JobInfo, JobStatus

__all__ = [
    "DEFAULT_COLUMNAR",
    "make_table",
    "PHASE_CODE",
    "PHASE_STRS",
    "STATE_CODE",
    "STATE_STRS",
    "JOBSTATUS_BY_CODE",
    "PHASE_OF_SINGLE_STATE",
    "CR_STATE_OF_PHASE",
    "CR_TERMINAL_CODES",
    "InfoScratch",
    "SIGNAL_COLS",
]

#: the kinds ObjectStore stores columnar by default — the high-churn pair
#: the PR-4 attribution singled out (135k of 137k per-tick commits)
DEFAULT_COLUMNAR = (Pod.KIND, BridgeJob.KIND)

# ---- code tables ------------------------------------------------------

#: pod phase ⇄ int8 code (order fixed: codes are stored on disk-shaped rows)
PHASE_STRS = (
    PodPhase.PENDING,
    PodPhase.RUNNING,
    PodPhase.SUCCEEDED,
    PodPhase.FAILED,
    PodPhase.UNKNOWN,
)
PHASE_CODE = {s: i for i, s in enumerate(PHASE_STRS)}

#: CR JobState ⇄ int8 code
STATE_STRS = (
    JobState.PENDING,
    JobState.SUBMITTED,
    JobState.RUNNING,
    JobState.SUCCEEDED,
    JobState.FAILED,
)
STATE_CODE = {s: i for i, s in enumerate(STATE_STRS)}
CR_TERMINAL_CODES = (STATE_CODE[JobState.SUCCEEDED], STATE_CODE[JobState.FAILED])

#: JobStatus is already an IntEnum 0..6 — index straight by wire value
JOBSTATUS_BY_CODE = tuple(JobStatus(i) for i in range(len(JobStatus)))

#: pod_phase_for([s]) for a single status, as an int8 lookup — the
#: vectorized mirror's phase derivation for the dominant one-job pods
#: (multi-job pods fall back to the loop oracle). Kept provably in sync
#: by tests/test_colstore.py.
PHASE_OF_SINGLE_STATE = np.array(
    [PHASE_CODE[pod_phase_for([s])] for s in JOBSTATUS_BY_CODE],
    dtype=np.int8,
)

#: job_state_for_pod_phase as an int8 lookup (Unknown phase → Pending CR)
CR_STATE_OF_PHASE = np.array(
    [
        STATE_CODE[JobState.SUBMITTED],  # Pending
        STATE_CODE[JobState.RUNNING],
        STATE_CODE[JobState.SUCCEEDED],
        STATE_CODE[JobState.FAILED],
        STATE_CODE[JobState.PENDING],  # Unknown
    ],
    dtype=np.int8,
)


def _ts(dt: datetime | None) -> int:
    """datetime → epoch seconds (wire/convert semantics); 0 = None."""
    if dt is None:
        return 0
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return int(dt.timestamp())


def dt_of_ts(ts: int) -> datetime | None:
    """epoch seconds → the naive-UTC datetime the wire decode produces."""
    if ts <= 0:
        return None
    return datetime.fromtimestamp(ts, tz=timezone.utc).replace(tzinfo=None)


class _LazyDT:
    """Sentinel stored in an info heap's submit/start object column when
    the datetime is derivable from the epoch column (the wire decode
    path — second resolution by construction). Readers derive on touch;
    the vectorized status writer skips 2×45k datetime builds per tick."""

    __slots__ = ()

    def __repr__(self):  # pragma: no cover - debugging aid
        return "<lazy-dt>"


LAZY_DT = _LazyDT()


def heap_dt(h, col: str, i: int) -> datetime | None:
    """The datetime at ``h.<col>[i]``, deriving lazies from ``<col>_ts``."""
    v = getattr(h, col)[i]
    if v is LAZY_DT:
        return dt_of_ts(int(getattr(h, col + "_ts")[i]))
    return v


def heap_iso(h, col: str, i: int) -> str:
    """ISO form of :func:`heap_dt` ("" for None) — the sub-job diff's
    string representation."""
    v = heap_dt(h, col, i)
    return "" if v is None else v.isoformat()


def heap_iso_bulk(h, col: str, idx: np.ndarray) -> np.ndarray:
    """:func:`heap_iso` over many heap rows at once (object array).

    The hot case — every row a :data:`LAZY_DT` sentinel, i.e. the wire
    decode wrote it — renders straight from the epoch column with
    ``np.datetime_as_string``, which at second resolution produces
    exactly ``datetime.isoformat()``'s ``YYYY-MM-DDTHH:MM:SS`` for the
    naive-UTC datetimes ``dt_of_ts`` would build (pinned by the
    colstore tests). Rows holding real datetime objects (the pb2 path)
    fall back to the scalar oracle; ``ts <= 0`` rows are ``""``.
    Replaces a per-row Python datetime build + isoformat that was ~2s
    of a cold 100k sweep (ISSUE 16)."""
    n = int(idx.size)
    out = np.empty(n, object)
    if not n:
        return out
    objs = getattr(h, col)[idx]
    lazy = np.fromiter(
        (v is LAZY_DT for v in objs), bool, n
    )
    if lazy.any():
        ts = getattr(h, col + "_ts")[idx]
        pos = ts > 0
        render = lazy & pos
        out[lazy & ~pos] = ""
        if render.any():
            out[render] = np.datetime_as_string(
                ts[render].astype("datetime64[s]"), unit="s"
            ).astype(object)
    rest = np.nonzero(~lazy)[0]
    for k in rest.tolist():
        v = objs[k]
        out[k] = "" if v is None else v.isoformat()
    return out


# make sure every materialized class carries the frozen guard before the
# first view is minted (freeze() would do this lazily; views bypass it)
for _cls in (
    Pod, PodSpec, PodStatus, Meta, BridgeJob, BridgeJobStatus,
    JobInfo, SubjobStatus, ContainerStatus,
):
    enable_guard(_cls)


# ---- schemas ----------------------------------------------------------

#: shared meta/status scalar columns for both kinds
_POD_SPEC = {
    # meta
    "name": "O", "uid": "O", "labels": "O", "ann": "O", "owner": "O",
    "rv": "i8", "deleted": "b1",
    # spec
    "role": "O", "partition": "O", "demand": "O", "node": "O", "hint": "O",
    # status
    "phase": "i1", "reason": "O", "job_ids": "O", "njobs": "i4",
    "istart": "i8", "ilen": "i4",  # job_infos segment
    "cstart": "i8", "clen": "i4",  # containers segment
}

#: all 18 JobInfo fields; submit/start carried as exact objects (for
#: materialization) AND epoch seconds (for vectorized diffs)
INFO_SPEC = {
    "id": "i8", "user_id": "O", "name": "O", "exit_code": "O", "state": "i1",
    "submit": "O", "start": "O", "submit_ts": "i8", "start_ts": "i8",
    "run_time": "i8", "limit": "i8", "workdir": "O", "stdout": "O",
    "stderr": "O", "partition": "O", "nodelist": "O", "batch_host": "O",
    "num_nodes": "i4", "array_id": "O", "reason": "O",
}

_CONTAINER_SPEC = {"cname": "O", "cstate": "O", "cexit": "i4", "creason": "O"}

_JOB_SPEC = {
    # meta
    "name": "O", "uid": "O", "labels": "O", "ann": "O", "owner": "O",
    "rv": "i8", "deleted": "b1",
    # spec (immutable on the hot paths: stored whole)
    "spec": "O",
    # status
    "state": "i1", "reason": "O", "fetch": "O", "endpoint": "O",
    "sstart": "i8", "slen": "i4",  # subjobs segment
    "skeys": "O",  # subjob dict keys, insertion order
}

SUBJOB_SPEC = {
    "id": "i8", "array_id": "O", "state": "i1", "exit_code": "O",
    "submit": "O", "start": "O", "run_time": "i8", "stdout": "O",
    "stderr": "O", "reason": "O",
}

#: columns update_rows treats as plain per-row scalar/object writes
_O_COLS_POD = tuple(n for n, d in _POD_SPEC.items() if d == "O")
_O_COLS_JOB = tuple(n for n, d in _JOB_SPEC.items() if d == "O")


def _frozen_shell(cls, fields: dict):
    """Build a frozen instance straight into ``__dict__`` (the
    view-materialization constructor — fast_new + born-frozen)."""
    obj = cls.__new__(cls)
    d = obj.__dict__
    d.update(fields)
    d[FROZEN_FLAG] = True
    return obj


def _meta_view(c, row: int) -> Meta:
    return _frozen_shell(Meta, {
        "name": c.name[row],
        "uid": c.uid[row],
        "labels": c.labels[row],
        "annotations": c.ann[row],
        "owner": c.owner[row],
        "resource_version": int(c.rv[row]),
        "deleted": bool(c.deleted[row]),
    })


def _write_meta(c, row: int, meta: Meta) -> None:
    d = meta.__dict__
    c.name[row] = d["name"]
    c.uid[row] = d["uid"]
    c.labels[row] = d["labels"]
    c.ann[row] = d["annotations"]
    c.owner[row] = d["owner"]
    c.rv[row] = d["resource_version"]
    c.deleted[row] = d["deleted"]


class _FrozenListView(list):
    """Materialization helper: a FrozenList without the generator
    round-trip (filled before any caller can see it)."""


def info_view(h, i: int) -> JobInfo:
    """One frozen JobInfo materialized from heap row ``i``."""
    return _frozen_shell(JobInfo, {
        "id": int(h.id[i]),
        "user_id": h.user_id[i],
        "name": h.name[i],
        "exit_code": h.exit_code[i],
        "state": JOBSTATUS_BY_CODE[h.state[i]],
        "submit_time": heap_dt(h, "submit", i),
        "start_time": heap_dt(h, "start", i),
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


def _write_info(h, i: int, info: JobInfo) -> None:
    d = info.__dict__
    h.id[i] = d["id"]
    h.user_id[i] = d["user_id"]
    h.name[i] = d["name"]
    h.exit_code[i] = d["exit_code"]
    h.state[i] = int(d["state"])
    h.submit[i] = d["submit_time"]
    h.start[i] = d["start_time"]
    h.submit_ts[i] = _ts(d["submit_time"])
    h.start_ts[i] = _ts(d["start_time"])
    h.run_time[i] = d["run_time_s"]
    h.limit[i] = d["time_limit_s"]
    h.workdir[i] = d["working_dir"]
    h.stdout[i] = d["std_out"]
    h.stderr[i] = d["std_err"]
    h.partition[i] = d["partition"]
    h.nodelist[i] = d["node_list"]
    h.batch_host[i] = d["batch_host"]
    h.num_nodes[i] = d["num_nodes"]
    h.array_id[i] = d["array_id"]
    h.reason[i] = d["reason"]


class PodAdapter:
    KIND = Pod.KIND
    SPEC = _POD_SPEC
    node_col = "node"

    def __init__(self):
        self.infos = SegmentHeap(INFO_SPEC)
        self.containers = SegmentHeap(_CONTAINER_SPEC)

    # -- store seam --

    def decompose(self, t: KindTable, row: int, obj: Pod) -> None:
        c = t.cols
        _write_meta(c, row, obj.meta)
        sd = obj.spec.__dict__
        c.role[row] = sd["role"]
        c.partition[row] = sd["partition"]
        c.demand[row] = sd["demand"]
        c.node[row] = sd["node_name"]
        c.hint[row] = sd["placement_hint"]
        st = obj.status.__dict__
        c.phase[row] = PHASE_CODE.get(st["phase"], PHASE_CODE[PodPhase.UNKNOWN])
        c.reason[row] = st["reason"]
        job_ids = st["job_ids"]
        c.job_ids[row] = job_ids
        c.njobs[row] = len(job_ids)
        self._write_infos(t, row, st["job_infos"])
        self._write_containers(t, row, st["containers"])

    def _write_infos(self, t: KindTable, row: int, infos) -> None:
        c, h = t.cols, self.infos
        if c.ilen[row]:
            h.retire(int(c.ilen[row]))
        n = len(infos)
        start = h.alloc(n) if n else 0
        for k, info in enumerate(infos):
            _write_info(h, start + k, info)
        c.istart[row] = start
        c.ilen[row] = n
        self._maybe_compact_infos(t)

    def _write_containers(self, t: KindTable, row: int, conts) -> None:
        c, h = t.cols, self.containers
        if c.clen[row]:
            h.retire(int(c.clen[row]))
        n = len(conts)
        start = h.alloc(n) if n else 0
        for k, ct in enumerate(conts):
            d = ct.__dict__
            i = start + k
            h.cname[i] = d["name"]
            h.cstate[i] = d["state"]
            h.cexit[i] = d["exit_code"]
            h.creason[i] = d["reason"]
        c.cstart[row] = start
        c.clen[row] = n
        self._maybe_compact_containers(t)

    def _maybe_compact_containers(self, t: KindTable) -> None:
        h = self.containers
        if not h.wasteful:
            return
        c = t.cols
        segs = [
            (r, int(c.cstart[r]), int(c.clen[r]))
            for r in t.row_of.values()
            if c.clen[r]
        ]
        for r, pos in h.compact(segs):
            c.cstart[r] = pos

    def _maybe_compact_infos(self, t: KindTable) -> None:
        h = self.infos
        if not h.wasteful:
            return
        c = t.cols
        segs = [
            (r, int(c.istart[r]), int(c.ilen[r]))
            for r in t.row_of.values()
            if c.ilen[r]
        ]
        for r, pos in h.compact(segs):
            c.istart[r] = pos

    def materialize(self, t: KindTable, row: int) -> Pod:
        c = t.cols
        h = self.infos
        istart, ilen = int(c.istart[row]), int(c.ilen[row])
        infos = _FrozenListView()
        for i in range(istart, istart + ilen):
            infos.append(info_view(h, i))
        ch = self.containers
        cstart, clen = int(c.cstart[row]), int(c.clen[row])
        conts = _FrozenListView()
        for i in range(cstart, cstart + clen):
            conts.append(_frozen_shell(ContainerStatus, {
                "name": ch.cname[i],
                "state": ch.cstate[i],
                "exit_code": int(ch.cexit[i]),
                "reason": ch.creason[i],
            }))
        infos.__class__ = FrozenList
        conts.__class__ = FrozenList
        return _frozen_shell(Pod, {
            "meta": _meta_view(c, row),
            "spec": _frozen_shell(PodSpec, {
                "role": c.role[row],
                "partition": c.partition[row],
                "demand": c.demand[row],
                "node_name": c.node[row],
                "placement_hint": c.hint[row],
            }),
            "status": _frozen_shell(PodStatus, {
                "phase": PHASE_STRS[c.phase[row]],
                "reason": c.reason[row],
                "job_ids": c.job_ids[row],
                "job_infos": infos,
                "containers": conts,
            }),
        })

    def release(self, t: KindTable, row: int) -> None:
        c = t.cols
        if c.ilen[row]:
            self.infos.retire(int(c.ilen[row]))
            c.ilen[row] = 0
        if c.clen[row]:
            self.containers.retire(int(c.clen[row]))
            c.clen[row] = 0
        for col in _O_COLS_POD:
            getattr(c, col)[row] = None

    def node_value(self, t: KindTable, row: int):
        node = t.cols.node[row]
        return node if isinstance(node, str) else None


class BridgeJobAdapter:
    KIND = BridgeJob.KIND
    SPEC = _JOB_SPEC
    node_col = None

    def __init__(self):
        self.subjobs = SegmentHeap(SUBJOB_SPEC)

    def decompose(self, t: KindTable, row: int, obj: BridgeJob) -> None:
        c = t.cols
        _write_meta(c, row, obj.meta)
        c.spec[row] = obj.spec
        st = obj.status.__dict__
        c.state[row] = STATE_CODE.get(st["state"], STATE_CODE[JobState.PENDING])
        c.reason[row] = st["reason"]
        c.fetch[row] = st["fetch_result"]
        c.endpoint[row] = st["cluster_endpoint"]
        self._write_subjobs(t, row, st["subjobs"])

    def _write_subjobs(self, t: KindTable, row: int, subjobs: dict) -> None:
        c, h = t.cols, self.subjobs
        if c.slen[row]:
            h.retire(int(c.slen[row]))
        n = len(subjobs)
        start = h.alloc(n) if n else 0
        keys = []
        for k, (key, sub) in enumerate(subjobs.items()):
            keys.append(key)
            d = sub.__dict__
            i = start + k
            h.id[i] = d["id"]
            h.array_id[i] = d["array_id"]
            h.state[i] = int(d["state"])
            h.exit_code[i] = d["exit_code"]
            h.submit[i] = d["submit_time"]
            h.start[i] = d["start_time"]
            h.run_time[i] = d["run_time_s"]
            h.stdout[i] = d["std_out"]
            h.stderr[i] = d["std_err"]
            h.reason[i] = d["reason"]
        c.sstart[row] = start
        c.slen[row] = n
        c.skeys[row] = tuple(keys)
        self._maybe_compact_subjobs(t)

    def _maybe_compact_subjobs(self, t: KindTable) -> None:
        h = self.subjobs
        if not h.wasteful:
            return
        c = t.cols
        segs = [
            (r, int(c.sstart[r]), int(c.slen[r]))
            for r in t.row_of.values()
            if c.slen[r]
        ]
        for r, pos in h.compact(segs):
            c.sstart[r] = pos

    def materialize(self, t: KindTable, row: int) -> BridgeJob:
        c, h = t.cols, self.subjobs
        start, n = int(c.sstart[row]), int(c.slen[row])
        subjobs: dict = {}
        for k in range(n):
            i = start + k
            subjobs[c.skeys[row][k]] = _frozen_shell(SubjobStatus, {
                "id": int(h.id[i]),
                "array_id": h.array_id[i],
                "state": JOBSTATUS_BY_CODE[h.state[i]],
                "exit_code": h.exit_code[i],
                "submit_time": h.submit[i],
                "start_time": h.start[i],
                "run_time_s": int(h.run_time[i]),
                "std_out": h.stdout[i],
                "std_err": h.stderr[i],
                "reason": h.reason[i],
            })
        fsubs = FrozenDict(subjobs)
        return _frozen_shell(BridgeJob, {
            "meta": _meta_view(c, row),
            "spec": c.spec[row],
            "status": _frozen_shell(BridgeJobStatus, {
                "state": STATE_STRS[c.state[row]],
                "reason": c.reason[row],
                "subjobs": fsubs,
                "fetch_result": c.fetch[row],
                "cluster_endpoint": c.endpoint[row],
            }),
        })

    def release(self, t: KindTable, row: int) -> None:
        c = t.cols
        if c.slen[row]:
            self.subjobs.retire(int(c.slen[row]))
            c.slen[row] = 0
        for col in _O_COLS_JOB:
            getattr(c, col)[row] = None

    def node_value(self, t: KindTable, row: int):
        return None


_ADAPTERS = {Pod.KIND: PodAdapter, BridgeJob.KIND: BridgeJobAdapter}


def make_table(kind: str) -> KindTable:
    adapter_cls = _ADAPTERS.get(kind)
    if adapter_cls is None:
        raise ValueError(f"no columnar schema for kind {kind!r}")
    adapter = adapter_cls()
    return KindTable(kind, adapter, ColumnBlock(adapter.SPEC))


# ---- proto → column decode (the mirror's batched status path) ---------


#: the *signal* fields — everything Slurm can change on a live job
#: without a requeue: the state machine itself, the start timestamp
#: (which is also the moment nodelist/batch_host become real), the exit
#: code, the free-text reason, and ``scontrol update``-able time_limit;
#: ``id`` rides along as a sanity anchor. Every other JobInfo field is
#: immutable once the job is submitted (a requeue that rewrites them
#: also moves state), so the mirror decodes and diffs ONLY these per
#: proto and re-reads the remaining fields for rows whose signal fired.
#: run_time ticks every call and is deliberately NOT a signal (PR-3's
#: "run_time ticking is not a change" contract).
SIGNAL_COLS = ("id", "state", "start_ts", "exit_code", "reason", "limit")


class InfoScratch:
    """JobsInfo response rows decoded into columns in two tiers.

    Tier 1 (:meth:`add_proto`) reads only the six :data:`SIGNAL_COLS`
    fields per proto and keeps the proto reference; the vectorized
    mirror compares signals against stored heap columns. Tier 2
    (:meth:`full_cols` for the batched writer, :meth:`info_object` for
    the per-pod fallback) decodes the remaining twelve fields — but only
    for rows whose signal actually moved, which in a steady tick is
    zero, so the per-proto cost drops from 19 field reads to 6.

    ``row_of_jid`` maps job id → scratch row; unknown ids get the
    UNKNOWN placeholder row — field-for-field ``vnode._unknown_info``.
    """

    __slots__ = (
        "jid", "id", "state", "start_ts", "exit_code", "reason", "limit",
        "protos", "row_of_jid", "arr",
    )

    def __init__(self):
        for f in self.__slots__[:-2]:
            setattr(self, f, [])
        self.row_of_jid: dict[int, int] = {}
        self.arr: dict[str, np.ndarray] | None = None

    def add_unknown(self, jid: int) -> None:
        if jid in self.row_of_jid:
            self.row_of_jid[jid] = -1
        else:
            self.row_of_jid[jid] = len(self.jid)
        self.jid.append(jid)
        self.id.append(jid)
        self.state.append(int(JobStatus.UNKNOWN))
        self.start_ts.append(0)
        self.exit_code.append("")
        self.reason.append("")
        self.limit.append(0)
        self.protos.append(None)

    def add_proto(self, jid: int, m) -> None:
        # inlined bookkeeping: this runs once per JobInfo row per mirror
        # tick (45k at the headline shape) and extra call frames showed up
        if jid in self.row_of_jid:
            # duplicate rows for one id (array sub-jobs): only the first
            # keeps the fast mapping; pods owning it fall back
            self.row_of_jid[jid] = -1
        else:
            self.row_of_jid[jid] = len(self.jid)
        self.jid.append(jid)
        self.id.append(int(m.id))
        self.state.append(int(m.status))
        self.start_ts.append(int(m.start_time))
        self.exit_code.append(m.exit_code)
        self.reason.append(m.reason)
        self.limit.append(int(m.time_limit_s))
        self.protos.append(m)

    _NUMERIC = {
        "jid": np.int64, "id": np.int64, "state": np.int8,
        "start_ts": np.int64, "limit": np.int64,
    }

    def finalize(self) -> dict[str, np.ndarray]:
        """Signal columns as NumPy arrays (jid + :data:`SIGNAL_COLS`)."""
        if self.arr is None:
            self.arr = {}
            for f in self.__slots__[:-3]:
                vals = getattr(self, f)
                dt = self._NUMERIC.get(f)
                if dt is not None:
                    self.arr[f] = np.asarray(vals, dtype=dt)
                else:
                    a = np.empty(len(vals), dtype=object)
                    a[:] = vals
                    self.arr[f] = a
        return self.arr

    _FULL_OBJ = (
        ("user_id", "user_id"), ("name", "name"), ("workdir", "working_dir"),
        ("stdout", "std_out"), ("stderr", "std_err"),
        ("partition", "partition"), ("nodelist", "node_list"),
        ("batch_host", "batch_host"), ("array_id", "array_id"),
    )

    def full_cols(self, ks) -> dict[str, np.ndarray]:
        """The full 18-column write set for scratch rows ``ks`` (dense,
        aligned with ``ks`` order) — the tier-2 decode, paid only for
        rows the signal compare flagged as changed."""
        arr = self.finalize()
        ks = np.asarray(ks, np.int64)
        out = {c: arr[c][ks] for c in SIGNAL_COLS}
        n = int(ks.size)
        submit_ts = np.zeros(n, np.int64)
        run_time = np.zeros(n, np.int64)
        num_nodes = np.zeros(n, np.int32)
        obj = {c: np.empty(n, object) for c, _ in self._FULL_OBJ}
        protos = self.protos
        for j, k in enumerate(ks.tolist()):
            m = protos[k]
            if m is None:
                for a in obj.values():
                    a[j] = ""
                continue
            submit_ts[j] = int(m.submit_time)
            run_time[j] = int(m.run_time_s)
            num_nodes[j] = int(m.num_nodes)
            for c, f in self._FULL_OBJ:
                obj[c][j] = getattr(m, f)
        out["submit_ts"] = submit_ts
        out["run_time"] = run_time
        out["num_nodes"] = num_nodes
        out.update(obj)
        return out

    def info_object(self, i: int) -> JobInfo:
        """Materialize one scratch row as a frozen JobInfo — the per-pod
        fallback path (multi-job pods, conflict retries)."""
        m = self.protos[i]
        if m is None:
            return _frozen_shell(JobInfo, {
                "id": int(self.jid[i]),
                "user_id": "", "name": "", "exit_code": "",
                "state": JobStatus.UNKNOWN,
                "submit_time": None, "start_time": None,
                "run_time_s": 0, "time_limit_s": 0,
                "working_dir": "", "std_out": "", "std_err": "",
                "partition": "", "node_list": "", "batch_host": "",
                "num_nodes": 0, "array_id": "", "reason": "",
            })
        return _frozen_shell(JobInfo, {
            "id": int(m.id),
            "user_id": m.user_id,
            "name": m.name,
            "exit_code": m.exit_code,
            "state": JOBSTATUS_BY_CODE[int(m.status)],
            "submit_time": dt_of_ts(int(m.submit_time)),
            "start_time": dt_of_ts(int(m.start_time)),
            "run_time_s": int(m.run_time_s),
            "time_limit_s": int(m.time_limit_s),
            "working_dir": m.working_dir,
            "std_out": m.std_out,
            "std_err": m.std_err,
            "partition": m.partition,
            "node_list": m.node_list,
            "batch_host": m.batch_host,
            "num_nodes": int(m.num_nodes),
            "array_id": m.array_id,
            "reason": m.reason,
        })


class ColdecScratch:
    """:class:`InfoScratch`'s zero-object sibling (ISSUE 14): the same
    tiered surface — signal arrays for the vectorized diff, tier-2 full
    columns for changed rows, per-row frozen-JobInfo materialization for
    the fallback — fed from :mod:`~slurm_bridge_tpu_torch.wire.coldec` chunk
    decodes instead of per-proto Python reads. Chunks append in request
    order; rows NOT returned by any chunk land as UNKNOWN placeholders
    at the tail (exactly where the pb2 path's ``add_unknown`` loop puts
    them), so row order — and therefore every downstream diff, write and
    digest — is identical to the pb2 path's by construction."""

    __slots__ = (
        "chunks", "row_of_jid", "arr", "_rows", "_tail", "_bounds", "_full",
        "frames",
    )

    def __init__(self):
        self.chunks: list = []  # coldec.JobsInfoChunk, request order
        self.row_of_jid: dict[int, int] = {}
        self.arr: dict[str, np.ndarray] | None = None
        self._rows = 0
        self._tail: list[int] = []  # UNKNOWN job ids appended after chunks
        self._bounds: np.ndarray | None = None
        self._full: dict[str, np.ndarray] | None = None
        #: chunk index -> colstore.CommitFrame, set by the frames mirror
        #: path (ISSUE 19) when pool workers pre-packed the tier-2
        #: strings; None = no frames, full_cols_framed ≡ full_cols
        self.frames: dict | None = None

    def add_chunk(self, c) -> None:
        """Fold one decoded ``JobsInfoResponse`` in (request order)."""
        self.chunks.append(c)
        d = self.row_of_jid
        base = self._rows
        jl = c.jid.tolist()
        if len(set(jl)) == len(jl) and d.keys().isdisjoint(jl):
            # the dominant case — every id new, no array sub-job rows:
            # one bulk dict update instead of a per-row probe loop
            d.update(zip(jl, range(base, base + len(jl))))
        else:
            for k, j in enumerate(jl):
                if j in d:
                    d[j] = -1  # duplicate rows for one id: fast map off
                else:
                    d[j] = base + k
        self._rows += c.rows

    def add_unknown(self, jid: int) -> None:
        if jid in self.row_of_jid:
            self.row_of_jid[jid] = -1
        else:
            self.row_of_jid[jid] = self._rows
        self._tail.append(jid)
        self._rows += 1

    @property
    def jid(self) -> np.ndarray:
        return self.finalize()["jid"]

    def _concat(self, name: str, tail_fill, dtype) -> np.ndarray:
        parts = [getattr(c, name) for c in self.chunks]
        if self._tail:
            if dtype is object:
                t = np.full(len(self._tail), tail_fill, object)
            else:
                t = np.full(len(self._tail), tail_fill, dtype)
            parts.append(t)
        if not parts:
            return np.empty(0, dtype)
        out = np.concatenate(parts) if len(parts) > 1 else parts[0]
        return out.astype(dtype, copy=False) if dtype is not object else out

    def finalize(self) -> dict[str, np.ndarray]:
        """Signal columns (jid + :data:`SIGNAL_COLS`), dtype-for-dtype
        what ``InfoScratch.finalize`` hands the vectorized diff."""
        if self.arr is None:
            tail_ids = np.asarray(self._tail, np.int64)
            unknown = int(JobStatus.UNKNOWN)
            arr = {
                "jid": self._concat("jid", 0, np.int64),
                "id": self._concat("id", 0, np.int64),
                "state": self._concat("state", unknown, np.int8),
                "start_ts": self._concat("start_ts", 0, np.int64),
                "exit_code": self._concat("exit_code", "", object),
                "reason": self._concat("reason", "", object),
                "limit": self._concat("limit", 0, np.int64),
            }
            if tail_ids.size:
                n = self._rows
                arr["jid"][n - tail_ids.size:] = tail_ids
                arr["id"][n - tail_ids.size:] = tail_ids
            self._bounds = np.concatenate(
                ([0], np.cumsum([c.rows for c in self.chunks], dtype=np.int64))
            ) if self.chunks else np.zeros(1, np.int64)
            self.arr = arr
        return self.arr

    def _full_numeric(self) -> dict[str, np.ndarray]:
        if self._full is None:
            self._full = {
                "submit_ts": self._concat("submit_ts", 0, np.int64),
                "run_time": self._concat("run_time", 0, np.int64),
                "num_nodes": self._concat("num_nodes", 0, np.int32),
            }
        return self._full

    #: tier-2 object columns (lazy string spans in the chunks)
    _OBJ_COLS = (
        "user_id", "name", "workdir", "stdout", "stderr",
        "partition", "nodelist", "batch_host", "array_id",
    )

    def full_cols(self, ks) -> dict[str, np.ndarray]:
        """The 18-column write set for global rows ``ks`` — numeric
        columns are gathers, strings materialize from the owning chunk's
        spans for exactly these rows (the tier-2 contract)."""
        from slurm_bridge_tpu_torch.wire.coldec import materialize_strings

        arr = self.finalize()
        ks = np.asarray(ks, np.int64)
        out = {c: arr[c][ks] for c in SIGNAL_COLS}
        num = self._full_numeric()
        for c in ("submit_ts", "run_time", "num_nodes"):
            out[c] = num[c][ks]
        obj = {c: np.full(int(ks.size), "", object) for c in self._OBJ_COLS}
        bounds = self._bounds
        ci = np.searchsorted(bounds, ks, side="right") - 1
        for c_idx in np.unique(ci).tolist():
            if c_idx >= len(self.chunks):
                continue  # tail UNKNOWN rows: all-"" defaults stand
            sel = np.nonzero(ci == c_idx)[0]
            local = ks[sel] - bounds[c_idx]
            chunk = self.chunks[c_idx]
            for cname in self._OBJ_COLS:
                s, ln = chunk.str_spans[cname]
                obj[cname][sel] = materialize_strings(
                    chunk.data, s[local], ln[local]
                )
        out.update(obj)
        return out

    def full_cols_framed(self, ks, on_fallback=None) -> dict[str, np.ndarray]:
        """:meth:`full_cols` that serves the tier-2 strings from worker-
        built commit frames (``self.frames``) where available, falling
        back to span materialization per chunk whose frame is missing,
        doesn't cover the requested rows (stale indices after the working
        set moved), or fails to decode — the frame path is all-or-nothing
        per chunk, so a bad frame can never mix frame and span values for
        one chunk's rows. ``on_fallback(rows)`` is called with the row
        count each time a chunk falls back (the frame-fallback counter).
        Value-for-value identical to :meth:`full_cols` by construction:
        frames carry the same utf8 bytes the spans point at."""
        from slurm_bridge_tpu_torch.bridge.colstore import FrameError
        from slurm_bridge_tpu_torch.wire.coldec import materialize_strings

        frames = self.frames
        if not frames:
            return self.full_cols(ks)
        arr = self.finalize()
        ks = np.asarray(ks, np.int64)
        out = {c: arr[c][ks] for c in SIGNAL_COLS}
        num = self._full_numeric()
        for c in ("submit_ts", "run_time", "num_nodes"):
            out[c] = num[c][ks]
        obj = {c: np.full(int(ks.size), "", object) for c in self._OBJ_COLS}
        bounds = self._bounds
        ci = np.searchsorted(bounds, ks, side="right") - 1
        for c_idx in np.unique(ci).tolist():
            if c_idx >= len(self.chunks):
                continue  # tail UNKNOWN rows: all-"" defaults stand
            sel = np.nonzero(ci == c_idx)[0]
            local = ks[sel] - bounds[c_idx]
            frame = frames.get(c_idx)
            if frame is not None:
                try:
                    got = frame.gather(local)
                    for cname in self._OBJ_COLS:
                        obj[cname][sel] = got[cname]
                    continue
                except FrameError:
                    if on_fallback is not None:
                        on_fallback(int(sel.size))
            elif on_fallback is not None:
                on_fallback(int(sel.size))
            chunk = self.chunks[c_idx]
            for cname in self._OBJ_COLS:
                s, ln = chunk.str_spans[cname]
                obj[cname][sel] = materialize_strings(
                    chunk.data, s[local], ln[local]
                )
        out.update(obj)
        return out

    def info_object(self, i: int) -> JobInfo:
        """One frozen JobInfo for global row ``i`` — the per-pod fallback
        path, field-for-field ``InfoScratch.info_object``."""
        full = self.full_cols(np.asarray([i], np.int64))
        arr = self.finalize()
        return _frozen_shell(JobInfo, {
            "id": int(arr["id"][i]),
            "user_id": full["user_id"][0],
            "name": full["name"][0],
            "exit_code": full["exit_code"][0],
            "state": JOBSTATUS_BY_CODE[int(arr["state"][i])],
            "submit_time": dt_of_ts(int(full["submit_ts"][0])),
            "start_time": dt_of_ts(int(arr["start_ts"][i])),
            "run_time_s": int(full["run_time"][0]),
            "time_limit_s": int(arr["limit"][i]),
            "working_dir": full["workdir"][0],
            "std_out": full["stdout"][0],
            "std_err": full["stderr"][0],
            "partition": full["partition"][0],
            "node_list": full["nodelist"][0],
            "batch_host": full["batch_host"][0],
            "num_nodes": int(full["num_nodes"][0]),
            "array_id": full["array_id"][0],
            "reason": full["reason"][0],
        })
