"""Columnar hot-state tables — the storage layer under :class:`ObjectStore`.

PR-4's attribution showed the residual cold tick is not one phase but
~135k per-object store commits, ~45k proto→dataclass decodes, and ~140k
frozen object builds smeared across mirror/sweep/bind (BASELINE.md PR-4).
The fix is the same discipline PR-1 proved on the encode path: column-
oriented state with vectorized diffs. This module provides the generic
machinery; :mod:`bridge.columns` declares the per-kind schemas (which
kinds are columnar, how an object decomposes into rows, how a frozen
dataclass view materializes back).

Three pieces:

- :class:`ColumnBlock` — named parallel arrays (NumPy numeric columns +
  object columns) with amortized growth; one logical row per stored
  object.
- :class:`SegmentHeap` — an append-only column block for variable-length
  nested rows (a pod's ``status.job_infos``, a CR's ``status.subjobs``):
  each parent row owns a contiguous ``(start, len)`` segment; rewrites
  allocate a fresh segment and retire the old one, and the heap compacts
  itself once retired rows dominate.
- :class:`KindTable` — the per-kind façade the store talks to: a
  ``name → row`` map, the schema's column blocks, and the **lazy view
  cache**: a frozen dataclass view is materialized only when some caller
  actually reads the object, and is keyed by the row's resource_version
  (exactly PR-1's ``JobRowCache`` discipline, applied to reads). Writes
  for columnar kinds go straight to rows — no frozen object is ever
  built for an object nothing reads.

Everything here is called with the owning store's lock held; the store
remains the only party that assigns resource versions, records changes,
notifies watchers, and attributes commits.
"""

from __future__ import annotations

import struct
import threading
import weakref

import numpy as np

__all__ = [
    "ColumnBlock",
    "CommitFrame",
    "FrameError",
    "SegmentHeap",
    "KindTable",
    "ROWS_GAUGE",
    "build_commit_frame",
    "object_array",
    "object_full",
]

#: dtype shorthand used by the schemas in :mod:`bridge.columns`
_DTYPES = {
    "i8": np.int64,
    "i4": np.int32,
    "i1": np.int8,
    "b1": np.bool_,
    "O": object,
}


def _empty(dt: str, cap: int) -> np.ndarray:
    if dt == "O":
        return np.empty(cap, dtype=object)
    return np.zeros(cap, dtype=_DTYPES[dt])


def object_array(vals) -> np.ndarray:
    """A 1-D object array holding ``vals`` verbatim — element-wise fill,
    because ``np.asarray`` mangles lists of (possibly ragged) tuples into
    2-D arrays and lists of str into ``np.str_`` scalars."""
    a = np.empty(len(vals), dtype=object)
    for i, v in enumerate(vals):
        a[i] = v
    return a


def object_full(n: int, value) -> np.ndarray:
    """A 1-D object array with every cell aliasing ``value``."""
    a = np.empty(n, dtype=object)
    for i in range(n):
        a[i] = value
    return a


class ColumnBlock:
    """Named parallel arrays with amortized doubling growth.

    Columns are plain attributes (``block.phase``, ``block.rv``) so hot
    readers pay one attribute load, not a dict probe per access.
    """

    def __init__(self, spec: dict[str, str], cap: int = 256):
        self._spec = dict(spec)
        self.cap = cap
        for name, dt in spec.items():
            setattr(self, name, _empty(dt, cap))

    def col(self, name: str) -> np.ndarray:
        return getattr(self, name)

    def names(self) -> tuple[str, ...]:
        return tuple(self._spec)

    def grow(self, need: int) -> None:
        if need <= self.cap:
            return
        new_cap = max(need, self.cap * 2)
        for name, dt in self._spec.items():
            old = getattr(self, name)
            arr = _empty(dt, new_cap)
            arr[: self.cap] = old[: self.cap]
            setattr(self, name, arr)
        self.cap = new_cap


class SegmentHeap(ColumnBlock):
    """Append-only column block for variable-length nested rows.

    ``alloc(n)`` hands out ``n`` contiguous rows at the tail;
    ``retire(n)`` only counts the dead rows. When retired rows outnumber
    live ones (past a floor), the owning :class:`KindTable` calls
    :meth:`compact` with the live segments and the heap is rebuilt
    densely — amortized O(1) per write, bounded memory under churn.
    """

    COMPACT_FLOOR = 4096

    def __init__(self, spec: dict[str, str], cap: int = 256):
        super().__init__(spec, cap)
        self.n = 0
        self.dead = 0

    def alloc(self, n: int) -> int:
        start = self.n
        self.grow(start + n)
        self.n = start + n
        return start

    def retire(self, n: int) -> None:
        self.dead += n

    @property
    def wasteful(self) -> bool:
        return self.dead > self.COMPACT_FLOOR and self.dead * 2 > self.n

    def compact(self, segments: list[tuple[int, int, int]]) -> list[tuple[int, int]]:
        """Rebuild densely from ``(tag, start, len)`` live segments;
        returns the new ``(tag, start)`` per segment (tags are opaque to
        the heap — the table passes row indices)."""
        total = sum(ln for _, _, ln in segments)
        cols = {name: _empty(dt, max(total, 256)) for name, dt in self._spec.items()}
        out: list[tuple[int, int]] = []
        pos = 0
        for tag, start, ln in segments:
            for name in self._spec:
                cols[name][pos : pos + ln] = getattr(self, name)[start : start + ln]
            out.append((tag, pos))
            pos += ln
        for name, arr in cols.items():
            setattr(self, name, arr)
        self.cap = max(total, 256)
        self.n = total
        self.dead = 0
        return out


# ---- commit frames (ISSUE 19) -----------------------------------------
#
# The partitioned-commit wire format: a pool worker that decoded+diffed a
# mirror chunk packages the tier-2 string columns for ITS changed rows as
# one raw frame — local row indices plus per-column (lens, utf8 payload)
# pairs sliced straight from the wire blob's lazy spans, the same framing
# discipline as parallel/writeops.py. No decode happens in the worker and
# no object crosses the pipe; the parent gathers strings lazily per
# committed row. The store-side merge (ObjectStore.apply_frames) scatters
# each partition's frame under ONE short lock in deterministic order, so
# rv assignment, events and dirty-set fan-out stay main-thread and the
# digests stay byte-identical to the serial column-scatter arm.

#: tier-2 string columns a commit frame carries, in frame order — must
#: stay in lockstep with ColdecScratch._OBJ_COLS (bridge/columns.py)
FRAME_COLS = (
    "user_id", "name", "workdir", "stdout", "stderr",
    "partition", "nodelist", "batch_host", "array_id",
)

_FRAME_VERSION = 1
#: header: version, covered-row count
_FRAME_HDR = struct.Struct("<qq")


class FrameError(ValueError):
    """A commit frame is malformed (truncated, wrong version, stale or
    uncovered row indices, undecodable payload). The caller falls back to
    the serial span-materialization arm for the affected rows — the pool
    stays healthy; this is a payload problem, never infrastructure."""


def build_commit_frame(chunk, rows_local) -> bytes:
    """Pack the commit frame for one decoded chunk's changed rows
    (chunk-local indices, ascending). Runs in the pool worker: the string
    payloads are raw utf8 slices lifted from the chunk's lazy spans —
    nothing is decoded here, so a worker can never observe (or mask) a
    bad-utf8 row the serial arm would have surfaced."""
    rows = np.ascontiguousarray(np.asarray(rows_local, np.int64))
    parts = [_FRAME_HDR.pack(_FRAME_VERSION, rows.size), rows.tobytes()]
    data = chunk.data
    for cname in FRAME_COLS:
        s, ln = chunk.str_spans[cname]
        ss = s[rows].tolist()
        ll = ln[rows].tolist()
        payload = b"".join(data[a : a + b] for a, b in zip(ss, ll))
        parts.append(struct.pack("<q", len(payload)))
        parts.append(np.ascontiguousarray(ln[rows], np.int64).tobytes())
        parts.append(payload)
    return b"".join(parts)


class CommitFrame:
    """Parsed parent-side view of one worker-built commit frame.

    Parsing validates framing only (version, lengths); string bytes stay
    raw until :meth:`gather` decodes exactly the rows a commit touches.
    Any inconsistency — truncation, rows the frame does not cover, utf8
    the spans should never have produced — raises :class:`FrameError`,
    and the caller re-runs the serial arm so a genuine decode problem
    surfaces through the same path it always did."""

    __slots__ = ("rows", "_lens", "_starts", "_payloads")

    def __init__(self, buf: bytes):
        buf = memoryview(buf)
        if len(buf) < _FRAME_HDR.size:
            raise FrameError("truncated commit frame header")
        version, n = _FRAME_HDR.unpack_from(buf, 0)
        if version != _FRAME_VERSION:
            raise FrameError(f"unknown commit frame version {version}")
        if n < 0:
            raise FrameError("negative row count")
        off = _FRAME_HDR.size
        if len(buf) < off + n * 8:
            raise FrameError("truncated commit frame row index block")
        self.rows = np.frombuffer(buf, np.int64, n, off).copy()
        off += n * 8
        self._lens: dict[str, np.ndarray] = {}
        self._starts: dict[str, np.ndarray] = {}
        self._payloads: dict[str, bytes] = {}
        for cname in FRAME_COLS:
            if len(buf) < off + 8:
                raise FrameError(f"truncated commit frame at column {cname}")
            (pay_n,) = struct.unpack_from("<q", buf, off)
            off += 8
            if pay_n < 0 or len(buf) < off + n * 8 + pay_n:
                raise FrameError(f"truncated commit frame at column {cname}")
            lens = np.frombuffer(buf, np.int64, n, off)
            off += n * 8
            if n and (int(lens.min()) < 0 or int(lens.sum()) != pay_n):
                raise FrameError(f"inconsistent lens for column {cname}")
            self._lens[cname] = lens
            self._starts[cname] = np.concatenate(
                ([0], np.cumsum(lens[:-1], dtype=np.int64))
            ) if n else np.zeros(0, np.int64)
            self._payloads[cname] = bytes(buf[off : off + pay_n])
            off += pay_n

    def positions(self, rows_local) -> np.ndarray:
        """Frame positions of chunk-local ``rows_local``; raises
        :class:`FrameError` when any requested row is not covered (a
        stale index after the working set moved, say)."""
        want = np.asarray(rows_local, np.int64)
        pos = np.searchsorted(self.rows, want)
        pos_c = np.minimum(pos, max(self.rows.size - 1, 0))
        if want.size and (
            not self.rows.size or not bool(np.all(self.rows[pos_c] == want))
        ):
            raise FrameError("commit frame does not cover requested rows")
        return pos_c

    def gather(self, rows_local) -> dict[str, np.ndarray]:
        """Decode the frame's string columns for chunk-local rows —
        value-for-value what span materialization over the wire blob
        yields for the same rows."""
        pos = self.positions(rows_local)
        out: dict[str, np.ndarray] = {}
        for cname in FRAME_COLS:
            payload = self._payloads[cname]
            starts = self._starts[cname][pos].tolist()
            lens = self._lens[cname][pos].tolist()
            col = np.empty(len(starts), object)
            try:
                for i, (a, b) in enumerate(zip(starts, lens)):
                    col[i] = payload[a : a + b].decode("utf-8")
            except UnicodeDecodeError as e:
                raise FrameError(f"bad utf8 in column {cname}: {e}") from e
            out[cname] = col
        return out


class _RowsCollector:
    """``sbt_colstore_rows{kind}`` — live row count per columnar kind,
    summed over every live table at scrape time (weakref-tracked, like
    the store's commits collector)."""

    name = "sbt_colstore_rows"
    help = "live rows per columnar kind across in-process stores"

    def __init__(self):
        self._tables: weakref.WeakSet = weakref.WeakSet()
        self._lock = threading.Lock()

    def track(self, table: "KindTable") -> None:
        with self._lock:
            self._tables.add(table)

    def totals(self) -> dict[str, int]:
        with self._lock:
            tables = list(self._tables)
        agg: dict[str, int] = {}
        for t in tables:
            agg[t.kind] = agg.get(t.kind, 0) + len(t.row_of)
        return agg

    def collect(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        for kind, n in sorted(self.totals().items()):
            out.append(f'{self.name}{{kind="{kind}"}} {n}')
        return out


ROWS_GAUGE = _RowsCollector()


class KindTable:
    """One columnar kind: name→row map, schema blocks, lazy view cache.

    The adapter (from :mod:`bridge.columns`) owns the schema-specific
    work: ``decompose(table, row, obj)`` writes an object's fields into
    columns, ``materialize(table, row)`` rebuilds a frozen dataclass
    view. The table owns row allocation and the view cache.
    """

    def __init__(self, kind: str, adapter, cols: ColumnBlock):
        self.kind = kind
        self.adapter = adapter
        self.cols = cols
        self.row_of: dict[str, int] = {}
        self._free: list[int] = []
        self._top = 0
        #: lazy frozen views: ``views[row]`` is valid iff
        #: ``view_rv[row] == cols.rv[row]`` — a row write invalidates by
        #: construction (the rv moves), no eviction bookkeeping needed
        self.views = _empty("O", cols.cap)
        self.view_rv = _empty("i8", cols.cap)
        #: observability: frozen views built / rows written through the
        #: columnar path, for the run-level decoded_views_total /
        #: rows_written_total diagnostics (ISSUE 6 satellite)
        self.view_builds = 0
        self.rows_written = 0
        ROWS_GAUGE.track(self)

    # ---- row allocation ----

    def alloc(self, name: str) -> int:
        if self._free:
            row = self._free.pop()
        else:
            row = self._top
            self._top += 1
            self.cols.grow(self._top)
            if self._top > self.views.shape[0]:
                for attr in ("views", "view_rv"):
                    old = getattr(self, attr)
                    arr = _empty("O" if attr == "views" else "i8", self.cols.cap)
                    arr[: old.shape[0]] = old
                    setattr(self, attr, arr)
        self.row_of[name] = row
        return row

    def release(self, name: str) -> int:
        row = self.row_of.pop(name)
        self.adapter.release(self, row)
        self.views[row] = None
        self.view_rv[row] = 0
        self._free.append(row)
        return row

    # ---- object seam (store CRUD goes through these) ----

    def insert(self, name: str, obj) -> int:
        """Store a fresh (already frozen) object as a row; the object
        itself seeds the view cache so the create's return value and the
        first read share identity with the oracle path."""
        row = self.alloc(name)
        self.adapter.decompose(self, row, obj)
        self.views[row] = obj
        self.view_rv[row] = self.cols.rv[row]
        return row

    def replace(self, row: int, obj) -> None:
        self.adapter.decompose(self, row, obj)
        self.views[row] = obj
        self.view_rv[row] = self.cols.rv[row]

    def view(self, row: int):
        """The frozen dataclass view of a row — cached per resource
        version, materialized only when actually read."""
        if self.view_rv[row] == self.cols.rv[row] and self.views[row] is not None:
            return self.views[row]
        obj = self.adapter.materialize(self, row)
        self.views[row] = obj
        self.view_rv[row] = self.cols.rv[row]
        self.view_builds += 1
        return obj

    # ---- bulk lookups used by the store ----

    def rows_for(self, names) -> np.ndarray:
        # list-comp + asarray beats fromiter-over-genexpr ~2× at the 45k
        # shapes every hot path resolves per tick
        get = self.row_of.get
        return np.asarray([get(n, -1) for n in names], np.int64)

    def alloc_bulk(self, names: list[str]) -> np.ndarray:
        """Allocate one row per (absent) name with ONE growth check —
        the create_rows fast path; caller guarantees names are new."""
        free = self._free
        row_of = self.row_of
        rows = np.empty(len(names), np.int64)
        top = self._top
        for i, name in enumerate(names):
            if free:
                row = free.pop()
            else:
                row = top
                top += 1
            row_of[name] = row
            rows[i] = row
        if top != self._top:
            self._top = top
            self.cols.grow(top)
            if top > self.views.shape[0]:
                for attr in ("views", "view_rv"):
                    old = getattr(self, attr)
                    arr = _empty("O" if attr == "views" else "i8", self.cols.cap)
                    arr[: old.shape[0]] = old
                    setattr(self, attr, arr)
        return rows

    def names_owned_by(self, owners: set) -> list[tuple[str, str]]:
        """(kind, name) for every live row whose owner is in ``owners``."""
        owner_col = self.cols.owner
        return [
            (self.kind, name)
            for name, row in self.row_of.items()
            if owner_col[row] in owners
        ]
