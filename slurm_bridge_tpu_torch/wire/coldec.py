"""Vectorized protobuf wire→column decoder for the bulk RPCs (ISSUE 14).

The cold/storm tick's dominant residual cost is not parsing bytes — the
protobuf C runtime does that quickly — it is the Python object churn on
either side of it: one ``JobsInfoEntry``/``JobInfo`` proto materialized,
attribute-read field by field, and discarded per row, 457k rows deep per
mirror pass at the 500k×100k shape. This module removes the objects: the
raw response **bytes** of the three bulk messages are scanned with NumPy
(varint tables + a per-nesting-level field walk that loops over *field
slots* and vectorizes over *messages*) and scattered straight into the
column arrays the mirror, the Nodes decode cache and the submit commit
path already consume. No pb2 object is constructed on the bulk path.

Layout of one decode:

1. The **top level** is walked in plain Python with inlined varint
   reads (it is one field per repeated entry — a NumPy "loop" there
   would pay kernel-dispatch per entry).
2. Nested levels use :class:`_Fields`, whose iteration count is the
   *max field count per message* (≈18 for JobInfo), each iteration one
   set of vector ops over all sibling messages at that depth; varints
   decode per POSITION SET (:func:`_varint_at` — one full-width pass
   for the dominant 1-byte case, compressed tails for longer ones).
3. Scalar fields scatter into int64/uint64 columns (proto3 last-wins via
   ordered fancy assignment); string fields land as ``(start, len)``
   span pairs into the original buffer and materialize Python ``str``
   objects lazily — absent fields (proto3 default "") cost nothing.

**Schema safety.** The field-tag tables below are hand-written (that is
the point: they are the drift risk) and mechanically verified against
the live ``workload_pb2`` descriptor — at import by :func:`verify_tables`
(a mismatch disables the decoder so callers fall back to the pb2 path,
the "unknown schema version" fallback) and in CI by
``hack/regen_pb2_noprotoc.py --check`` (a schema edit that forgets this
decoder fails the hygiene job instead of silently misparsing).

**Failure posture.** Torn or truncated bytes, overrunning lengths,
oversized varints and group wire types raise :class:`DecodeError` —
never garbage columns. Unknown and out-of-order fields decode exactly as
the pb2 path would (skipped / last-wins); the fuzz suite in
``tests/test_coldec.py`` holds decoder ≡ pb2 over randomized protos.
"""

from __future__ import annotations

import numpy as np

from slurm_bridge_tpu_torch.wire import messages as pb

__all__ = [
    "DecodeError",
    "decode_jobs_info",
    "decode_nodes",
    "decode_submit_jobs",
    "verify_tables",
    "available",
    "JobsInfoChunk",
    "NodesDecoded",
    "SubmitResults",
    "uvarint",
    "read_uvarint",
]


class DecodeError(ValueError):
    """Malformed wire bytes — callers fall back to the pb2 decode (which
    will surface the same malformation through the protobuf runtime)."""


# ---- wire-type constants ----------------------------------------------

VARINT, I64, LEN, I32 = 0, 1, 2, 5

# ---- the hand field-tag tables (verified against the descriptor) ------
#
# name → (field number, wire type, repeated). Hand-written so a schema
# edit MUST touch this file; `verify_tables` + the hygiene gate make
# forgetting loud. Only messages reachable from the three bulk responses
# appear.

TABLES: dict[str, dict[str, tuple[int, int, bool]]] = {
    "JobsInfoResponse": {
        "jobs": (1, LEN, True),
        "version": (2, VARINT, False),
    },
    "JobsInfoEntry": {
        "job_id": (1, VARINT, False),
        "found": (2, VARINT, False),
        "info": (3, LEN, True),
    },
    "JobInfo": {
        "id": (1, VARINT, False),
        "user_id": (2, LEN, False),
        "name": (3, LEN, False),
        "exit_code": (4, LEN, False),
        "status": (5, VARINT, False),
        "submit_time": (6, VARINT, False),
        "start_time": (7, VARINT, False),
        "run_time_s": (8, VARINT, False),
        "time_limit_s": (9, VARINT, False),
        "working_dir": (10, LEN, False),
        "std_out": (11, LEN, False),
        "std_err": (12, LEN, False),
        "partition": (13, LEN, False),
        "node_list": (14, LEN, False),
        "batch_host": (15, LEN, False),
        "num_nodes": (16, VARINT, False),
        "array_id": (17, LEN, False),
        "reason": (18, LEN, False),
    },
    "NodesResponse": {
        "nodes": (1, LEN, True),
        "version": (2, VARINT, False),
        "unchanged": (3, VARINT, False),
    },
    "Node": {
        "name": (1, LEN, False),
        "cpus": (2, VARINT, False),
        "alloc_cpus": (3, VARINT, False),
        "memory_mb": (4, VARINT, False),
        "alloc_memory_mb": (5, VARINT, False),
        "gpus": (6, VARINT, False),
        "alloc_gpus": (7, VARINT, False),
        "gpu_type": (8, LEN, False),
        "features": (9, LEN, True),
        "state": (10, LEN, False),
    },
    "SubmitJobsResponse": {
        "results": (1, LEN, True),
    },
    "SubmitJobsEntry": {
        "job_id": (1, VARINT, False),
        "ok": (2, VARINT, False),
        "error_code": (3, LEN, False),
        "error": (4, LEN, False),
    },
}

#: proto field type → the wire type its scalar encoding uses (the subset
#: present in the bulk messages; everything else fails verify_tables)
_WIRE_OF_TYPE = {
    3: VARINT,   # int64
    5: VARINT,   # int32
    8: VARINT,   # bool
    9: LEN,      # string
    11: LEN,     # message
    14: VARINT,  # enum
}


def verify_tables() -> list[str]:
    """Diff :data:`TABLES` against the live descriptor; returns the list
    of mismatches (empty = in sync). The hygiene gate fails CI on any;
    at import a mismatch flips :func:`available` off so every caller
    falls back to the pb2 path instead of misparsing."""
    problems: list[str] = []
    pool = pb.DESCRIPTOR.message_types_by_name
    for msg_name, table in TABLES.items():
        desc = pool.get(msg_name)
        if desc is None:
            problems.append(f"{msg_name}: message absent from schema")
            continue
        by_name = {f.name: f for f in desc.fields}
        for fname, (num, wt, rep) in table.items():
            f = by_name.get(fname)
            if f is None:
                problems.append(f"{msg_name}.{fname}: absent from schema")
                continue
            if f.number != num:
                problems.append(
                    f"{msg_name}.{fname}: number {f.number} != table {num}"
                )
            want_wt = _WIRE_OF_TYPE.get(f.type)
            if want_wt is None:
                problems.append(
                    f"{msg_name}.{fname}: unsupported field type {f.type}"
                )
            elif want_wt != wt:
                problems.append(
                    f"{msg_name}.{fname}: wire type {want_wt} != table {wt}"
                )
            actual_rep = (
                f.is_repeated
                if hasattr(type(f), "is_repeated")
                else f.label == f.LABEL_REPEATED  # pragma: no cover
            )
            if actual_rep != rep:
                problems.append(f"{msg_name}.{fname}: repeated-ness drifted")
        for f in desc.fields:
            if f.name not in table:
                problems.append(
                    f"{msg_name}.{f.name}: field {f.number} missing from "
                    "coldec table — update wire/coldec.py with the schema"
                )
    return problems


_SCHEMA_OK: bool | None = None
_ROWS_TOTAL = None
_FALLBACK_TOTAL = None


def rows_counter():
    """``sbt_wire_coldec_rows_total`` — rows decoded straight from wire
    bytes into columns (lazy: wire stays importable without obs)."""
    global _ROWS_TOTAL
    if _ROWS_TOTAL is None:
        from slurm_bridge_tpu_torch.obs.metrics import REGISTRY

        _ROWS_TOTAL = REGISTRY.counter(
            "sbt_wire_coldec_rows_total",
            "bulk-RPC rows decoded by the vectorized wire->column decoder",
        )
    return _ROWS_TOTAL


def fallback_counter():
    """``sbt_wire_coldec_fallback_total{method}`` — decodes that fell
    back to the pb2 path (schema drift, malformed bytes, agents without
    the bulk RPCs)."""
    global _FALLBACK_TOTAL
    if _FALLBACK_TOTAL is None:
        from slurm_bridge_tpu_torch.obs.metrics import REGISTRY

        _FALLBACK_TOTAL = REGISTRY.counter(
            "sbt_wire_coldec_fallback_total",
            "bulk-RPC decodes that engaged the pb2 fallback path",
        )
    return _FALLBACK_TOTAL


def available() -> bool:
    """Whether the decoder's tables match the running schema (memoized).
    False = every consumer uses the pb2 path — the unknown-schema
    fallback of ISSUE 14 satellite 6."""
    global _SCHEMA_OK
    if _SCHEMA_OK is None:
        problems = verify_tables()
        if problems:  # pragma: no cover - requires a drifted schema
            import logging

            logging.getLogger("sbt.wire").warning(
                "coldec tables drifted from schema; pb2 fallback engaged: %s",
                "; ".join(problems),
            )
        _SCHEMA_OK = not problems
    return _SCHEMA_OK


# ---- scalar varint helpers (top-level walk + serializers) -------------


def read_uvarint(data: bytes, pos: int) -> tuple[int, int]:
    """(value, next position) for the varint at ``pos`` — plain-Python,
    used only on the top-level walk (one per repeated entry)."""
    result = 0
    shift = 0
    n = len(data)
    while True:
        if pos >= n:
            raise DecodeError("truncated varint")
        b = data[pos]
        result |= (b & 0x7F) << shift
        pos += 1
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise DecodeError("varint over 10 bytes")


def uvarint(value: int) -> bytes:
    """Serialize one unsigned varint (the hand serializers' primitive)."""
    if value < 0:
        value &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


# ---- the NumPy wire scan ----------------------------------------------


def _varint_at(b: np.ndarray, pos: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Decode the varints starting at each position in ``pos``:
    ``(value uint64, length int64)``. A truncated or >10-byte varint
    reports length 0 (the caller raises). Vectorized over the position
    SET — per-byte tables over the whole buffer cost ~10 passes over
    every payload byte; this gathers only at real varint sites, pays the
    full-width ops ONCE (the dominant 1-byte case), and compresses to
    the continuing subset for longer varints."""
    n = b.size
    m = pos.size
    if not m:
        return np.empty(0, np.uint64), np.empty(0, np.int64)
    inb = pos < n
    clean = bool(inb.all())
    byte = b[pos if clean else np.minimum(pos, n - 1)]
    val = (byte & np.uint8(0x7F)).astype(np.uint64)
    cont = byte >= 0x80
    vlen = np.ones(m, np.int64)
    if not clean:
        vlen[~inb] = 0  # truncated at the very start
        cont &= inb
    if not cont.any():
        return val, vlen
    # slow tail: ONLY the continuing positions ride further iterations
    idx = np.nonzero(cont)[0]
    cur = pos[idx] + 1
    shift = np.uint64(7)
    for k in range(1, 10):
        inb = cur < n
        if not inb.all():
            vlen[idx[~inb]] = 0  # truncated mid-varint
            idx, cur = idx[inb], cur[inb]
            if not idx.size:
                return val, vlen
        byte = b[cur]
        val[idx] += (byte & np.uint8(0x7F)).astype(np.uint64) << shift
        more = byte >= 0x80
        done = ~more
        vlen[idx[done]] = k + 1
        idx, cur = idx[more], cur[more] + 1
        if not idx.size:
            return val, vlen
        shift += np.uint64(7)
    vlen[idx] = 0  # over 10 bytes: malformed
    return val, vlen


class _Fields:
    """All fields of M sibling messages with byte ranges
    ``[starts[i], ends[i])``, walked breadth-first: iteration k visits
    the k-th field of every message that still has one, so the loop
    count is the MAX field count per message (~18 for JobInfo) while
    every per-iteration op vectorizes over all M messages. Collected
    field records are ordered by occurrence rank — exactly what proto3
    last-wins scatter needs. Raises :class:`DecodeError` on torn
    varints, bogus lengths, or group wire types."""

    __slots__ = (
        "data", "m", "midx", "tag", "fno", "wt", "fval", "pstart", "plen",
    )

    def __init__(self, b: np.ndarray, data: bytes, starts, ends, m: int):
        self.data = data
        self.m = m
        n = b.size
        midx_p: list = []
        tag_p: list = []
        fval_p: list = []
        ps_p: list = []
        pl_p: list = []
        cur = starts.astype(np.int64, copy=True)
        end = ends.astype(np.int64, copy=False)
        mi = np.arange(cur.size, dtype=np.int64)
        while cur.size:
            live = cur < end
            if not live.all():
                cur, end, mi = cur[live], end[live], mi[live]
                if not cur.size:
                    break
            tag, tlen = _varint_at(b, cur)
            if bool((tlen == 0).any()):
                raise DecodeError("truncated field tag")
            tag = tag.astype(np.int64)
            if bool((tag < 8).any()):
                # field number 0 is invalid on the wire — pb2 rejects
                # it, so must we (the decoder≡pb2 contract)
                raise DecodeError("field number 0")
            wt = tag & 7
            vpos = cur + tlen
            is_len = wt == LEN
            need = (wt == VARINT) | is_len
            if need.all():
                vval, vvlen = _varint_at(b, vpos)
                if bool((vvlen == 0).any()):
                    raise DecodeError("truncated field value")
            else:
                vval = np.zeros(cur.size, np.uint64)
                vvlen = np.zeros(cur.size, np.int64)
                if need.any():
                    vv, vl = _varint_at(b, vpos[need])
                    if bool((vl == 0).any()):
                        raise DecodeError("truncated field value")
                    vval[need] = vv
                    vvlen[need] = vl
            plen = np.minimum(vval, np.uint64(n + 1)).astype(np.int64)
            pstart = vpos + vvlen
            # the common bulk layout is pure varint/len fields: next is
            # pstart (+payload for len) — one multiply instead of a
            # 4-deep where; rare wire types take the general form
            if need.all():
                nxt = pstart + plen * is_len
            else:
                nxt = np.where(
                    need, pstart + plen * is_len,
                    np.where(
                        wt == I32, vpos + 4,
                        np.where(wt == I64, vpos + 8, np.int64(n + 1)),
                    ),
                )
            if bool((nxt > end).any()):
                raise DecodeError(
                    "field overruns message bounds (torn bytes?)"
                )
            midx_p.append(mi)
            tag_p.append(tag)
            fval_p.append(vval)
            ps_p.append(pstart)
            pl_p.append(plen)
            cur = nxt
        if not midx_p:
            z = np.empty(0, np.int64)
            self.midx = self.tag = self.pstart = self.plen = z
            self.fval = np.empty(0, np.uint64)
            return
        if len(midx_p) == 1:
            self.midx, self.tag = midx_p[0], tag_p[0]
            self.fval, self.pstart, self.plen = fval_p[0], ps_p[0], pl_p[0]
        else:
            self.midx = np.concatenate(midx_p)
            self.tag = np.concatenate(tag_p)
            self.fval = np.concatenate(fval_p)
            self.pstart = np.concatenate(ps_p)
            self.plen = np.concatenate(pl_p)

    def varint_i64(self, field_no: int, default: int = 0) -> np.ndarray:
        """Signed-int64 column (proto int64/int32/enum/bool semantics)."""
        sel = self.tag == (field_no << 3 | VARINT)
        col = np.full(self.m, default, np.int64)
        col[self.midx[sel]] = self.fval[sel].astype(np.int64)
        return col

    def spans(self, field_no: int) -> tuple[np.ndarray, np.ndarray]:
        """(start, len) span columns for a string field; absent rows get
        start = -1 (materialize as "")."""
        sel = self.tag == (field_no << 3 | LEN)
        midx = self.midx[sel]
        start = np.full(self.m, -1, np.int64)
        length = np.zeros(self.m, np.int64)
        start[midx] = self.pstart[sel]
        length[midx] = self.plen[sel]
        return start, length

    def submessages(self, field_no: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(parent midx, payload starts, payload ends) of every
        occurrence of a repeated message field, occurrence-ordered."""
        sel = self.tag == (field_no << 3 | LEN)
        return self.midx[sel], self.pstart[sel], self.pstart[sel] + self.plen[sel]

    def strings(self, field_no: int) -> np.ndarray:
        """Materialized str column (absent → "") — eager form for the
        low-row-count messages (submit results, nodes)."""
        start, length = self.spans(field_no)
        return materialize_strings(self.data, start, length)


def materialize_strings(data: bytes, start: np.ndarray, length: np.ndarray) -> np.ndarray:
    """Object column of ``str`` from span pairs; only present, non-empty
    spans pay a decode (proto3 never serializes empty strings, so the
    common absent case is a fill)."""
    out = np.full(start.size, "", object)
    present = np.nonzero(start >= 0)[0]
    if present.size:
        try:
            for i in present.tolist():
                s = int(start[i])
                out[i] = data[s : s + int(length[i])].decode("utf-8")
        except UnicodeDecodeError as e:  # pb2 rejects it too
            raise DecodeError(f"invalid UTF-8 in string field: {e}") from None
    return out


def _walk_top(data: bytes) -> list[tuple[int, int, int, int]]:
    """Top-level fields as ``(field_no, wire_type, a, b)`` where a/b are
    (value, 0) for varints and (payload start, payload end) for
    length-delimited fields. Plain Python with inlined varint reads: the
    top level of a bulk response is one field per repeated entry, where
    a vectorized walk would pay NumPy dispatch per entry and a helper
    call per varint doubles the loop cost."""
    out: list[tuple[int, int, int, int]] = []
    append = out.append
    pos, n = 0, len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        if tag < 8:
            # field number 0: invalid on the wire, pb2 rejects it
            raise DecodeError("field number 0")
        if tag >= 0x80:
            tag &= 0x7F
            shift = 7
            while True:
                if pos >= n:
                    raise DecodeError("truncated varint")
                byte = data[pos]
                pos += 1
                tag |= (byte & 0x7F) << shift
                if byte < 0x80:
                    break
                shift += 7
                if shift >= 70:
                    raise DecodeError("varint over 10 bytes")
        wt = tag & 7
        if wt == LEN:
            if pos >= n:
                raise DecodeError("truncated varint")
            ln = data[pos]
            pos += 1
            if ln >= 0x80:
                ln &= 0x7F
                shift = 7
                while True:
                    if pos >= n:
                        raise DecodeError("truncated varint")
                    byte = data[pos]
                    pos += 1
                    ln |= (byte & 0x7F) << shift
                    if byte < 0x80:
                        break
                    shift += 7
                    if shift >= 70:
                        raise DecodeError("varint over 10 bytes")
            end = pos + ln
            if end > n:
                raise DecodeError("length-delimited field overruns buffer")
            append((tag >> 3, LEN, pos, end))
            pos = end
        elif wt == VARINT:
            v, pos = read_uvarint(data, pos)
            append((tag >> 3, VARINT, v, 0))
        elif wt == I64:
            pos += 8
        elif wt == I32:
            pos += 4
        else:
            raise DecodeError(f"unsupported wire type {wt} at top level")
        if pos > n:
            raise DecodeError("truncated field at top level")
    return out


def _i64(v: int) -> int:
    """uint64 wire value → signed int64 (proto int64/int32 semantics)."""
    return v - (1 << 64) if v >= (1 << 63) else v


# ---- JobsInfoResponse --------------------------------------------------

#: JobInfo string fields decoded lazily for tier-2 (column name →
#: field number) — matches InfoScratch._FULL_OBJ's column names
_INFO_STR_FIELDS = (
    ("user_id", 2), ("name", 3), ("workdir", 10), ("stdout", 11),
    ("stderr", 12), ("partition", 13), ("nodelist", 14),
    ("batch_host", 15), ("array_id", 17),
)


class JobsInfoChunk:
    """One decoded ``JobsInfoResponse``: per-row columns in exactly the
    accumulation order the pb2 path's :class:`InfoScratch` would produce
    (entry order; ``found=False``/info-less entries yield one UNKNOWN
    placeholder row, found entries one row per ``info`` message).

    Signal + numeric columns are dense arrays; the nine immutable string
    fields stay as spans into :attr:`data` and materialize only for rows
    the caller's diff flags (the tier-2 contract)."""

    __slots__ = (
        "data", "version", "rows", "jid",
        "id", "state", "start_ts", "limit", "submit_ts", "run_time",
        "num_nodes", "exit_code", "reason", "str_spans",
    )

    def __init__(self, data, version, rows, jid, cols, exit_code, reason, spans):
        self.data = data
        self.version = version
        self.rows = rows
        self.jid = jid
        self.id = cols["id"]
        self.state = cols["state"]
        self.start_ts = cols["start_ts"]
        self.limit = cols["limit"]
        self.submit_ts = cols["submit_ts"]
        self.run_time = cols["run_time"]
        self.num_nodes = cols["num_nodes"]
        self.exit_code = exit_code
        self.reason = reason
        #: col name → (start, len) spans for the tier-2 string fields
        self.str_spans = spans


def decode_jobs_info(data: bytes) -> JobsInfoChunk:
    """Decode one ``JobsInfoResponse`` wire buffer into columns."""
    version = 0
    entry_starts: list[int] = []
    entry_ends: list[int] = []
    for fno, wt, a, b in _walk_top(data):
        if fno == 1 and wt == LEN:
            entry_starts.append(a)
            entry_ends.append(b)
        elif fno == 2 and wt == VARINT:
            version = _i64(a)
    m = len(entry_starts)
    if m == 0:
        empty = np.empty(0, np.int64)
        return JobsInfoChunk(
            data, version, 0, empty,
            {k: empty for k in (
                "id", "state", "start_ts", "limit", "submit_ts",
                "run_time", "num_nodes",
            )},
            np.empty(0, object), np.empty(0, object),
            {k: (empty, empty) for k, _ in _INFO_STR_FIELDS},
        )
    b = np.frombuffer(data, np.uint8)
    ef = _Fields(
        b, data,
        np.asarray(entry_starts, np.int64), np.asarray(entry_ends, np.int64), m,
    )
    ejid = ef.varint_i64(1)
    efound = ef.varint_i64(2) != 0
    ipar, istart, iend = ef.submessages(3)
    # entry-major, occurrence-ordered info rows (stable sort keeps the
    # per-entry occurrence order _walk produced)
    order = np.argsort(ipar, kind="stable")
    ipar, istart, iend = ipar[order], istart[order], iend[order]
    icount = np.bincount(ipar, minlength=m)
    present = efound & (icount > 0)
    # row layout: present entries contribute their info rows, everything
    # else exactly one UNKNOWN placeholder — InfoScratch's accumulation
    per_entry = np.where(present, icount, 1)
    offsets = np.concatenate(([0], np.cumsum(per_entry)))
    rows = int(offsets[-1])
    # occurrence rank of each info row within its entry
    first_of = np.concatenate(([0], np.cumsum(icount)))
    rank = np.arange(ipar.size, dtype=np.int64) - first_of[ipar]
    keep = present[ipar]
    kpar, krank = ipar[keep], rank[keep]
    dest = offsets[kpar] + krank  # global row index of each kept info msg
    # decode JobInfo fields for ALL info messages (a malformed dropped
    # submessage must still error, as pb2's parse would), scatter kept
    jf = _Fields(b, data, istart, iend, int(ipar.size))
    from slurm_bridge_tpu_torch.core.types import JobStatus

    unknown_state = int(JobStatus.UNKNOWN)
    # every row carries its entry's job id: forward-fill entry index
    steps = np.zeros(rows, np.int64)
    steps[offsets[:-1]] = 1
    entry_of_row = np.cumsum(steps) - 1
    jid_col = ejid[entry_of_row]
    cols = {}
    for cname, fno in (
        ("id", 1), ("state", 5), ("start_ts", 7), ("limit", 9),
        ("submit_ts", 6), ("run_time", 8), ("num_nodes", 16),
    ):
        full = jf.varint_i64(fno)
        col = np.zeros(rows, np.int64)
        col[dest] = full[keep]
        cols[cname] = col
    # UNKNOWN placeholder rows: id = entry job id, state = UNKNOWN
    unk_rows = offsets[:-1][~present]
    cols["id"][unk_rows] = ejid[~present]
    cols["state"][unk_rows] = unknown_state
    # signal strings (exit_code f4, reason f18) materialized eagerly —
    # the vector diff compares their VALUES; absent = "" costs a fill
    def scatter_str(fno: int) -> np.ndarray:
        s, ln = jf.spans(fno)
        start = np.full(rows, -1, np.int64)
        length = np.zeros(rows, np.int64)
        start[dest] = s[keep]
        length[dest] = ln[keep]
        return materialize_strings(data, start, length)

    exit_code = scatter_str(4)
    reason = scatter_str(18)
    spans = {}
    for cname, fno in _INFO_STR_FIELDS:
        s, ln = jf.spans(fno)
        start = np.full(rows, -1, np.int64)
        length = np.zeros(rows, np.int64)
        start[dest] = s[keep]
        length[dest] = ln[keep]
        spans[cname] = (start, length)
    return JobsInfoChunk(
        data, version, rows, jid_col, cols, exit_code, reason, spans
    )


# ---- NodesResponse -----------------------------------------------------


class NodesDecoded:
    """One decoded ``NodesResponse``."""

    __slots__ = ("version", "unchanged", "nodes")

    def __init__(self, version: int, unchanged: bool, nodes: list):
        self.version = version
        self.unchanged = unchanged
        #: list[NodeInfo] — field-for-field what ``nodes_from_protos``
        #: yields for the same bytes
        self.nodes = nodes


def decode_nodes(data: bytes) -> NodesDecoded:
    """Decode one ``NodesResponse`` buffer into the NodeInfo list the
    pb2 path produces (``node_from_proto`` semantics, including the
    ``state or "IDLE"`` default)."""
    from slurm_bridge_tpu_torch.core.types import NodeInfo

    version = 0
    unchanged = False
    starts: list[int] = []
    ends: list[int] = []
    for fno, wt, a, b in _walk_top(data):
        if fno == 1 and wt == LEN:
            starts.append(a)
            ends.append(b)
        elif fno == 2 and wt == VARINT:
            version = _i64(a)
        elif fno == 3 and wt == VARINT:
            unchanged = a != 0
    m = len(starts)
    if m == 0:
        return NodesDecoded(version, unchanged, [])
    b = np.frombuffer(data, np.uint8)
    nf = _Fields(b, data, np.asarray(starts, np.int64), np.asarray(ends, np.int64), m)
    name = nf.strings(1)
    cpus = nf.varint_i64(2)
    alloc_cpus = nf.varint_i64(3)
    memory_mb = nf.varint_i64(4)
    alloc_memory_mb = nf.varint_i64(5)
    gpus = nf.varint_i64(6)
    alloc_gpus = nf.varint_i64(7)
    gpu_type = nf.strings(8)
    state = nf.strings(10)
    fpar, fs, fe = nf.submessages(9)  # repeated string: spans, parent-tagged
    feats: list = [()] * m
    if fpar.size:
        order = np.argsort(fpar, kind="stable")
        for k in order.tolist():
            p = int(fpar[k])
            s = int(fs[k])
            feats[p] = feats[p] + (data[s : int(fe[k])].decode("utf-8"),)
    nodes = []
    append = nodes.append
    new = NodeInfo.__new__
    for i in range(m):
        n = new(NodeInfo)
        n.__dict__.update(
            name=name[i],
            cpus=int(cpus[i]),
            alloc_cpus=int(alloc_cpus[i]),
            memory_mb=int(memory_mb[i]),
            alloc_memory_mb=int(alloc_memory_mb[i]),
            gpus=int(gpus[i]),
            alloc_gpus=int(alloc_gpus[i]),
            gpu_type=gpu_type[i],
            features=feats[i],
            state=state[i] or "IDLE",
        )
        append(n)
    return NodesDecoded(version, unchanged, nodes)


# ---- SubmitJobsResponse ------------------------------------------------


class SubmitResults:
    """One decoded ``SubmitJobsResponse``: parallel result columns."""

    __slots__ = ("n", "job_id", "ok", "error_code", "error")

    def __init__(self, n, job_id, ok, error_code, error):
        self.n = n
        self.job_id = job_id
        self.ok = ok
        self.error_code = error_code
        self.error = error

    @property
    def all_ok(self) -> bool:
        return bool(self.ok.all()) if self.n else True


def decode_submit_jobs(data: bytes) -> SubmitResults:
    starts: list[int] = []
    ends: list[int] = []
    for fno, wt, a, b in _walk_top(data):
        if fno == 1 and wt == LEN:
            starts.append(a)
            ends.append(b)
    m = len(starts)
    if m == 0:
        e = np.empty(0, np.int64)
        o = np.empty(0, object)
        return SubmitResults(0, e, np.empty(0, bool), o, o)
    b = np.frombuffer(data, np.uint8)
    rf = _Fields(b, data, np.asarray(starts, np.int64), np.asarray(ends, np.int64), m)
    return SubmitResults(
        m,
        rf.varint_i64(1),
        rf.varint_i64(2) != 0,
        rf.strings(3),
        rf.strings(4),
    )
