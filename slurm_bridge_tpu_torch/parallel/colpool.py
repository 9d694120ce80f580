"""Process worker pool for the bulk-decode cold path (ISSUE 16).

The mirror's dominant cold-tick cost is no longer protobuf parsing —
:mod:`~slurm_bridge_tpu_torch.wire.coldec` already vectorized that — it is
that every chunk's NumPy decode still runs on the ONE interpreter the
classification, diff and write machinery also needs. This module moves
the per-chunk ``coldec`` work into forked worker processes and ships the
resulting columns back **pickle-free**: each response is one raw-bytes
frame of concatenated little-endian column buffers (``np.frombuffer``
on the receive side — no object graph crosses the pipe in either
direction; the request frame is the wire blob itself).

Topology: N fork()ed workers, one duplex pipe each, fed round-robin by
index so chunk → worker assignment is deterministic. Results merge in
REQUEST order regardless of completion order — the decoded columns are
byte-identical to the serial path's by construction, and the fuzz suite
(``tests/test_colpool.py``) holds pool ≡ serial over randomized protos.

Sizing: ``SBT_COLPOOL_WORKERS`` pins the width (0 disables); otherwise
the pool takes ``cores - 1`` from the CPU affinity mask, so a 1-core
box (or a constrained cgroup) degrades to the inline serial path with
zero pool overhead — the serial oracle is not a fallback mode, it IS
the pool at width 0. Fork is required (the workers inherit the coldec
tables by address); platforms without it also degrade to width 0.

Failure posture: a malformed blob raises :class:`coldec.DecodeError`
in the worker and is re-raised per-chunk in the parent — exactly the
serial path's per-chunk fallback contract. An infrastructure failure
(worker death, torn pipe) permanently disables the pool for the
process and decodes the remaining chunks inline; it can never corrupt
a column, only cost the speedup.

Write side (ISSUE 18): two more ops run the cold path's remaining
single-thread loops in the workers — ``_OP_ENCODE_SUBMIT`` serializes
``SubmitJobsRequest`` chunk bytes from demand columns, and
``_OP_BUILD_ROWS`` resolves the operator sweep's sizecar demand/label
scalars. The frames live in :mod:`~slurm_bridge_tpu_torch.parallel.writeops`;
a payload failure on either op (a malformed array spec, say) reports
per-chunk like a DecodeError and sends the CALLER back to its serial
arm — which re-raises the real exception in context — without breaking
the pool. Infrastructure failures break the pool exactly as on the
decode side: remembered, inline from then on.

Partitioned commit (ISSUE 19): ``_OP_DIFF_FRAMES`` extends the diff op —
the worker that decoded+diffed a chunk also packs the commit frame
(:func:`colstore.build_commit_frame`) for the chunk's changed rows, so
the tier-2 string spans the store commit will need arrive pre-sliced
with the decode instead of being materialized on the main thread. A
frame-build failure inside the worker degrades to a frameless chunk
(the parent materializes spans as before) — never an error.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import struct
import threading
import time

import numpy as np

from slurm_bridge_tpu_torch.obs.metrics import REGISTRY
from slurm_bridge_tpu_torch.wire import coldec

__all__ = [
    "ColPool",
    "active_pool",
    "configured_width",
    "decode_serial",
    "diff_signals",
    "empty_prior",
    "reset",
    "set_obs",
]

log = logging.getLogger("sbt.colpool")

_OP_DECODE = 0x01
_OP_SET_PRIOR = 0x02
_OP_DECODE_DIFF = 0x03
_OP_ENCODE_SUBMIT = 0x04
_OP_BUILD_ROWS = 0x05
_OP_DIFF_FRAMES = 0x06
_OP_METRICS = 0x07
_ST_OK = 0x00
_ST_DECODE_ERR = 0x01
_ST_ERROR = 0x02

#: the write-side ops: request body and reply body are writeops frames
_WRITE_OPS = (_OP_ENCODE_SUBMIT, _OP_BUILD_ROWS)

#: op byte → metric/span label
_OP_NAMES = {
    _OP_DECODE: "decode",
    _OP_SET_PRIOR: "set_prior",
    _OP_DECODE_DIFF: "decode_diff",
    _OP_ENCODE_SUBMIT: "encode_submit",
    _OP_BUILD_ROWS: "build_rows",
    _OP_DIFF_FRAMES: "diff_frames",
    _OP_METRICS: "metrics",
}

#: request framing (ISSUE 20): op byte + the parent's monotonic_ns send
#: stamp. CLOCK_MONOTONIC is system-wide on Linux and the workers are
#: fork()ed on the same host, so worker recv stamp − this = queue wait.
_REQ = struct.Struct("<Bq")
_REQ_OFF = _REQ.size
#: reply timing header (ISSUE 20): queue-wait ns, op ns, body bytes in,
#: body bytes out — fixed width, after the status byte on EVERY reply
#: (errors included), so the parent strips it unconditionally.
_THDR = struct.Struct("<qqqq")
_RESP_OFF = 1 + _THDR.size

# -- parent-side worker self-timing (folded from the reply headers) ------

_busy_seconds = REGISTRY.counter(
    "sbt_colpool_worker_busy_seconds_total",
    "worker-side op compute time by op, from the reply timing headers",
)
_queue_wait_seconds = REGISTRY.counter(
    "sbt_colpool_queue_wait_seconds_total",
    "request time spent queued in worker pipes, by op",
)
_bytes_total = REGISTRY.counter(
    "sbt_colpool_bytes_total",
    "frame payload bytes through the pool, by op and direction",
)
_chunks_total = REGISTRY.counter(
    "sbt_colpool_chunks_total", "chunks served by the pool, by op"
)

#: parent-side fold switch (ISSUE 20): headers always ride the frames —
#: the workers need no config — but metric/span folding can be disabled
#: (the paired profile_fleet_obs_overhead off-arm).
_OBS_ENABLED = True


def set_obs(enabled: bool) -> None:
    """Enable/disable parent-side folding of worker timing headers into
    metrics + synthetic ``colpool.<op>`` spans. Digest-neutral either
    way; the off-arm exists for the paired overhead profile."""
    global _OBS_ENABLED
    _OBS_ENABLED = bool(enabled)


class _OpStats:
    """Per-batch accumulator for reply timing headers (thread-safe: the
    fan-out threads all add to the one batch's stats)."""

    __slots__ = ("queue_ns", "op_ns", "bytes_in", "bytes_out", "chunks", "_lock")

    def __init__(self):
        self.queue_ns = 0
        self.op_ns = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.chunks = 0
        self._lock = threading.Lock()

    def add(self, queue_ns: int, op_ns: int, bi: int, bo: int) -> None:
        with self._lock:
            self.queue_ns += queue_ns
            self.op_ns += op_ns
            self.bytes_in += bi
            self.bytes_out += bo
            self.chunks += 1


def _fold_op(label: str, stats: _OpStats, wall_s: float) -> None:
    """Fold one batch's worker timing into the parent's metrics and — when
    an ambient sampled span is open (the flight recorder's per-tick
    window) — a synthetic ``colpool.<label>`` child span whose duration is
    the summed worker busy time. Queue wait, wall time and byte volumes
    ride as counters; nothing here enters determinism digests."""
    if not _OBS_ENABLED or stats.chunks == 0:
        return
    busy_s = stats.op_ns / 1e9
    queue_s = stats.queue_ns / 1e9
    _busy_seconds.inc(busy_s, op=label)
    _queue_wait_seconds.inc(queue_s, op=label)
    _bytes_total.inc(float(stats.bytes_in), op=label, direction="in")
    _bytes_total.inc(float(stats.bytes_out), op=label, direction="out")
    _chunks_total.inc(float(stats.chunks), op=label)
    from slurm_bridge_tpu_torch.obs.tracing import TRACER

    parent = TRACER.current()
    if parent is not None and parent.sampled:
        TRACER.emit_synthetic(
            f"colpool.{label}",
            parent=parent,
            duration_s=busy_s,
            counters={
                "chunks": float(stats.chunks),
                "queue_wait_ms": queue_s * 1e3,
                "wall_ms": wall_s * 1e3,
                "bytes_in": float(stats.bytes_in),
                "bytes_out": float(stats.bytes_out),
            },
        )

#: response-frame column order for the fixed int64 block (length = rows
#: each); must match JobsInfoChunk's numeric slots
_I64_COLS = (
    "jid", "id", "state", "start_ts", "limit",
    "submit_ts", "run_time", "num_nodes",
)
#: lazy string-span fields, in frame order (matches coldec's tier-2 set)
_SPAN_COLS = tuple(name for name, _ in coldec._INFO_STR_FIELDS)

#: header: version, rows, exit-payload bytes, reason-payload bytes
_HDR = struct.Struct("<qqqq")

#: signal columns the diff op compares (the mirror's tier-1 contract —
#: keep in lockstep with bridge/vnode.py's _SIGNAL_DIFF_COLS)
_DIFF_I64 = ("id", "state", "start_ts", "limit")
_DIFF_STR = ("exit_code", "reason")


# ---- frame pack/unpack (shared by worker and parent) -------------------


def _pack_str_col(col: np.ndarray) -> tuple[bytes, bytes]:
    """(lens int64 buffer, utf8 payload) for one object str column."""
    bs = [s.encode("utf-8") for s in col.tolist()]
    lens = np.fromiter(map(len, bs), np.int64, len(bs))
    return lens.tobytes(), b"".join(bs)


def _unpack_str_col(buf, off: int, rows: int, payload_len: int):
    """Inverse of :func:`_pack_str_col`; returns (column, next offset)."""
    lens = np.frombuffer(buf, np.int64, rows, off)
    off += rows * 8
    out = np.full(rows, "", object)
    if payload_len:
        payload = bytes(buf[off : off + payload_len])
        ends = np.cumsum(lens)
        starts = ends - lens
        for i in np.nonzero(lens)[0].tolist():
            out[i] = payload[starts[i] : ends[i]].decode("utf-8")
    return out, off + payload_len


def _pack_chunk(chunk) -> bytes:
    """One JobsInfoChunk as a raw column frame (no ``data`` — the parent
    re-attaches its own copy of the wire blob for the lazy spans)."""
    rows = chunk.rows
    exit_lens, exit_pay = _pack_str_col(chunk.exit_code)
    rsn_lens, rsn_pay = _pack_str_col(chunk.reason)
    parts = [_HDR.pack(chunk.version, rows, len(exit_pay), len(rsn_pay))]
    for name in _I64_COLS:
        parts.append(np.ascontiguousarray(
            getattr(chunk, name), np.int64).tobytes())
    parts += [exit_lens, exit_pay, rsn_lens, rsn_pay]
    for name in _SPAN_COLS:
        start, length = chunk.str_spans[name]
        parts.append(np.ascontiguousarray(start, np.int64).tobytes())
        parts.append(np.ascontiguousarray(length, np.int64).tobytes())
    return b"".join(parts)


def _unpack_chunk(buf, data: bytes):
    """Rebuild a JobsInfoChunk from a column frame + the original wire
    blob (span fields index into ``data`` exactly as a local decode's
    would). Columns are writable copies — indistinguishable from the
    serial decode's freshly-allocated arrays."""
    version, rows, exit_n, rsn_n = _HDR.unpack_from(buf, 0)
    off = _HDR.size
    cols = {}
    for name in _I64_COLS:
        cols[name] = np.frombuffer(buf, np.int64, rows, off).copy()
        off += rows * 8
    exit_code, off = _unpack_str_col(buf, off, rows, exit_n)
    reason, off = _unpack_str_col(buf, off, rows, rsn_n)
    spans = {}
    for name in _SPAN_COLS:
        start = np.frombuffer(buf, np.int64, rows, off).copy()
        off += rows * 8
        length = np.frombuffer(buf, np.int64, rows, off).copy()
        off += rows * 8
        spans[name] = (start, length)
    jid = cols.pop("jid")
    return coldec.JobsInfoChunk(
        data, version, rows, jid,
        {k: cols[k] for k in (
            "id", "state", "start_ts", "limit", "submit_ts",
            "run_time", "num_nodes",
        )},
        exit_code, reason, spans,
    ), off


def _pack_prior(prior: dict) -> bytes:
    """Prior signal columns (jid-ascending) as one frame."""
    n = int(prior["jid"].size)
    exit_lens, exit_pay = _pack_str_col(prior["exit_code"])
    rsn_lens, rsn_pay = _pack_str_col(prior["reason"])
    parts = [struct.pack("<qqq", n, len(exit_pay), len(rsn_pay))]
    for name in ("jid",) + _DIFF_I64:
        parts.append(np.ascontiguousarray(prior[name], np.int64).tobytes())
    parts += [exit_lens, exit_pay, rsn_lens, rsn_pay]
    return b"".join(parts)


def _unpack_prior(buf) -> dict:
    n, exit_n, rsn_n = struct.unpack_from("<qqq", buf, 0)
    off = struct.calcsize("<qqq")
    prior = {}
    for name in ("jid",) + _DIFF_I64:
        prior[name] = np.frombuffer(buf, np.int64, n, off)
        off += n * 8
    prior["exit_code"], off = _unpack_str_col(buf, off, n, exit_n)
    prior["reason"], off = _unpack_str_col(buf, off, n, rsn_n)
    return prior


def diff_signals(chunk, prior: dict) -> np.ndarray:
    """Changed-row mask for one decoded chunk against prior signal
    columns: True where the row's job id is absent from ``prior`` or any
    signal column differs from the prior value. ``prior`` maps column
    name → array with ``jid`` ascending — the serial oracle the worker
    op and the fuzz suite both run."""
    pj = prior["jid"]
    rows = chunk.rows
    if pj.size == 0:
        return np.ones(rows, bool)
    pos = np.searchsorted(pj, chunk.jid)
    pos_c = np.minimum(pos, pj.size - 1)
    known = pj[pos_c] == chunk.jid
    changed = ~known
    for name in _DIFF_I64:
        changed |= getattr(chunk, name) != prior[name][pos_c]
    for name in _DIFF_STR:
        changed |= getattr(chunk, name) != prior[name][pos_c]
    changed[~known] = True
    return changed


def empty_prior() -> dict:
    """An empty prior for the diff/frames ops: :func:`diff_signals`
    marks every row changed against it, so a frames caller with no
    incremental cursor (the cold mirror) gets frames covering all
    returned rows — which is exactly the cold tick's changed-set."""
    prior: dict = {"jid": np.empty(0, np.int64)}
    for name in _DIFF_I64:
        prior[name] = np.empty(0, np.int64)
    for name in _DIFF_STR:
        prior[name] = np.empty(0, object)
    return prior


def decode_serial(blobs: list[bytes]) -> list:
    """The serial oracle: per-blob results in order, each a
    ``JobsInfoChunk`` or the ``DecodeError`` it raised — exactly the
    pool's per-chunk contract, minus the processes."""
    out = []
    for raw in blobs:
        try:
            out.append(coldec.decode_jobs_info(raw))
        except coldec.DecodeError as e:
            out.append(e)
    return out


# ---- the worker process ------------------------------------------------


def _worker_main(conn, inherited=()) -> None:  # pragma: no cover - runs in the child
    # the parent's ends of this worker's pipe and of its elder
    # siblings' pipes came along with the fork: holding them open
    # would keep recv() below from ever seeing EOF once the parent
    # is gone, and the orphan would live on holding the parent's
    # inherited descriptors
    for c in inherited:
        c.close()
    # Fork hygiene (ISSUE 20): the child inherits the parent's registry
    # (and every total it had accumulated) by COW. Swap in a FRESH
    # registry instead of resetting in place: a parent thread may have
    # held a metric lock at fork time, so touching inherited locks here
    # could deadlock the worker before it serves its first op. Anything
    # the worker registers from now on lands on the clean registry, so a
    # worker-side scrape (_OP_METRICS) can never double-count parent
    # totals.
    from slurm_bridge_tpu_torch.obs import metrics as _obs_metrics

    _obs_metrics.REGISTRY = _registry = _obs_metrics.MetricsRegistry()
    _ops_served = _registry.counter(
        "sbt_colpool_worker_ops_total",
        "ops served by this forked colpool worker, by op",
    )
    prior: dict | None = None
    while True:
        try:
            frame = conn.recv_bytes()
        except (EOFError, OSError):
            break
        if not frame:
            break  # shutdown sentinel
        recv_ns = time.monotonic_ns()
        op = frame[0]
        (sent_ns,) = struct.unpack_from("<q", frame, 1)
        body_in = len(frame) - _REQ_OFF
        t0 = time.monotonic_ns()
        try:
            if op == _OP_SET_PRIOR:
                prior = _unpack_prior(memoryview(frame)[_REQ_OFF:])
                st, body = _ST_OK, b""
            elif op in (_OP_DECODE, _OP_DECODE_DIFF, _OP_DIFF_FRAMES):
                blob = frame[_REQ_OFF:]
                chunk = coldec.decode_jobs_info(blob)
                body = _pack_chunk(chunk)
                if op == _OP_DECODE_DIFF:
                    mask = diff_signals(
                        chunk, prior if prior is not None else
                        {"jid": np.empty(0, np.int64)},
                    )
                    body += np.ascontiguousarray(mask, np.uint8).tobytes()
                elif op == _OP_DIFF_FRAMES:
                    # lazy, like the write ops: colstore only loads in
                    # workers once a frames caller engages
                    from slurm_bridge_tpu_torch.bridge import colstore

                    mask = diff_signals(
                        chunk, prior if prior is not None else
                        {"jid": np.empty(0, np.int64)},
                    )
                    try:
                        cf = colstore.build_commit_frame(
                            chunk, np.nonzero(mask)[0]
                        )
                    except Exception:
                        # frame build is an optimization, not a result:
                        # degrade to a frameless chunk and let the
                        # parent materialize spans as before
                        cf = b""
                    body += struct.pack("<q", len(cf)) + cf
                st = _ST_OK
            elif op in _WRITE_OPS:
                # lazy: the ops only need writeops once a write-side
                # caller engages; a decode-only worker never imports it
                from slurm_bridge_tpu_torch.parallel import writeops

                fn = (
                    writeops.encode_submit_frame
                    if op == _OP_ENCODE_SUBMIT
                    else writeops.build_rows_frame
                )
                try:
                    st, body = _ST_OK, fn(memoryview(frame)[_REQ_OFF:])
                except Exception as e:
                    # payload problem (malformed array spec, bad utf8):
                    # per-chunk like a DecodeError — the caller reruns
                    # its serial arm, which raises the real exception in
                    # context; the pool itself stays healthy
                    st, body = _ST_DECODE_ERR, repr(e).encode("utf-8")
            elif op == _OP_METRICS:
                # debug scrape: this worker's own (post-fork) counters
                st = _ST_OK
                body = json.dumps({
                    "pid": os.getpid(),
                    "counters": _registry.counter_totals(),
                }).encode("utf-8")
            else:
                st, body = _ST_ERROR, f"unknown op {op}".encode()
        except coldec.DecodeError as e:
            st, body = _ST_DECODE_ERR, str(e).encode("utf-8")
        except BaseException as e:
            st, body = _ST_ERROR, repr(e).encode("utf-8")
        op_ns = time.monotonic_ns() - t0
        _ops_served.inc(1.0, op=_OP_NAMES.get(op, str(op)))
        out = (
            bytes([st])
            + _THDR.pack(max(0, recv_ns - sent_ns), op_ns, body_in, len(body))
            + body
        )
        try:
            conn.send_bytes(out)
        except (BrokenPipeError, OSError):
            break


class PoolBroken(RuntimeError):
    """Infrastructure failure (worker death / torn pipe) — the caller
    decodes inline; never surfaced as a DecodeError."""


class PayloadError(RuntimeError):
    """A write-op chunk failed INSIDE its compute (malformed array spec,
    undecodable frame) — the pool is healthy, but the caller must rerun
    its serial arm so the real exception surfaces in context."""


class _WriteJob:
    """One in-flight write-op fan-out, kicked without blocking the
    caller: packing AND the pipe round-trips run on the fan-out threads,
    so the kicking thread (the operator sweep's locked capture, say)
    keeps the interpreter while the workers chew. ``wait()`` joins and
    returns per-chunk reply bytes in request order, or ``None`` when the
    caller must run its serial arm — pool broken (remembered, like the
    decode side) or a per-chunk payload failure (pool stays up)."""

    def __init__(self, pool: "ColPool", op: int, chunks: list, pack_fn):
        self._pool = pool
        self._op = op
        self._stats = _OpStats()
        self._t0 = time.perf_counter()
        n = len(chunks)
        self._results: list = [None] * n
        self._infra: list[BaseException] = []
        self._payload: list[str] = []
        width = min(pool.width, n)

        def run(w: int) -> None:
            try:
                for i in range(w, n, width):
                    try:
                        body = pack_fn(chunks[i])
                    except Exception as e:
                        # pack blew up on chunk data: a payload problem,
                        # not pool infrastructure — serial arm re-raises
                        self._payload.append(repr(e))
                        return
                    st, rbody = self._pool._round_trip(
                        w, op, body, self._stats
                    )
                    if st == _ST_OK:
                        self._results[i] = bytes(rbody)
                    elif st == _ST_DECODE_ERR:
                        self._payload.append(
                            bytes(rbody).decode("utf-8", "replace")
                        )
                        return
                    else:
                        raise PoolBroken(
                            bytes(rbody).decode("utf-8", "replace")
                        )
            except (EOFError, OSError, IndexError, PoolBroken) as e:
                self._infra.append(e)

        self._threads = [
            threading.Thread(target=run, args=(w,), daemon=True)
            for w in range(width)
        ]
        for t in self._threads:
            t.start()

    def wait(self) -> list[bytes] | None:
        for t in self._threads:
            t.join()
        if self._infra:
            log.warning(
                "colpool broken; write ops inline from now on: %s",
                self._infra[0],
            )
            self._pool._break()
            return None
        if self._payload:
            log.warning(
                "colpool write op payload failure; serial arm re-runs: %s",
                self._payload[0],
            )
            return None
        # fold at collect time: the waiting thread carries the ambient
        # span (the kicking thread may have moved on long ago)
        _fold_op(
            _OP_NAMES.get(self._op, str(self._op)),
            self._stats,
            time.perf_counter() - self._t0,
        )
        return self._results


class ColPool:
    """N forked decode workers over raw-bytes pipes (lazily started)."""

    def __init__(self, width: int):
        self.width = max(1, int(width))
        self._procs: list = []
        self._conns: list = []
        self._locks: list[threading.Lock] = []
        self._start_lock = threading.Lock()
        self._broken = False

    # -- lifecycle --

    def _ensure(self) -> bool:
        if self._conns:
            return True
        if self._broken:
            return False
        with self._start_lock:
            if self._conns or self._broken:
                return bool(self._conns)
            try:
                import multiprocessing

                ctx = multiprocessing.get_context("fork")
                for _ in range(self.width):
                    parent, child = ctx.Pipe(duplex=True)
                    proc = ctx.Process(
                        target=_worker_main,
                        args=(child, [parent, *self._conns]),
                        daemon=True,
                    )
                    proc.start()
                    child.close()
                    self._procs.append(proc)
                    self._conns.append(parent)
                    self._locks.append(threading.Lock())
            except (ValueError, OSError) as e:
                log.warning("colpool start failed; decoding inline: %s", e)
                self._break()
                return False
        return True

    def _break(self) -> None:
        self._broken = True
        self.close()

    def close(self) -> None:
        """Reap the workers. Idempotent and deliberately LOCK-FREE: the
        list swaps are single bytecodes under the GIL, so a second close
        (harness teardown racing atexit, say) finds empty lists and
        returns — and ``_break()`` may call this while ``_ensure`` still
        holds ``_start_lock``, so taking it here would deadlock."""
        conns, self._conns = self._conns, []
        procs, self._procs = self._procs, []
        self._locks = []
        for conn in conns:
            try:
                conn.send_bytes(b"")
            except (BrokenPipeError, OSError):
                pass
            try:
                conn.close()
            except OSError:
                pass
        for proc in procs:
            proc.join(timeout=2.0)
            if proc.is_alive():  # pragma: no cover - stuck worker
                proc.terminate()

    # -- ops --

    def _round_trip(
        self, w: int, op: int, body: bytes, stats: _OpStats | None = None
    ) -> tuple[int, memoryview]:
        """One request/reply exchange with worker ``w`` — the single choke
        point for ALL pool traffic. Stamps the request with monotonic_ns
        (the worker derives queue wait from it), strips the reply's fixed
        timing header into ``stats``, and returns ``(status, body view)``."""
        conn = self._conns[w]
        frame = _REQ.pack(op, time.monotonic_ns()) + body
        with self._locks[w]:
            conn.send_bytes(frame)
            resp = conn.recv_bytes()
        if stats is not None:
            queue_ns, op_ns, bi, bo = _THDR.unpack_from(resp, 1)
            stats.add(queue_ns, op_ns, bi, bo)
        return resp[0], memoryview(resp)[_RESP_OFF:]

    def _run_op(
        self, op: int, blobs: list[bytes], with_mask: bool,
        with_frame: bool = False, stats: _OpStats | None = None,
    ) -> list:
        """Fan ``blobs`` across the workers (round-robin by index) and
        collect per-blob results in request order: JobsInfoChunk (or
        (chunk, mask) for the diff op, (chunk, frame bytes | None) for
        the frames op) or DecodeError. Raises :class:`PoolBroken` on
        infrastructure failure."""
        results: list = [None] * len(blobs)
        width = min(self.width, len(blobs))
        errors: list[BaseException] = []

        def run(w: int) -> None:
            try:
                for i in range(w, len(blobs), width):
                    st, body = self._round_trip(w, op, blobs[i], stats)
                    if st == _ST_DECODE_ERR:
                        results[i] = coldec.DecodeError(
                            bytes(body).decode("utf-8", "replace")
                        )
                    elif st == _ST_OK:
                        chunk, off = _unpack_chunk(body, blobs[i])
                        if with_frame:
                            (frame_n,) = struct.unpack_from("<q", body, off)
                            fbytes = bytes(
                                body[off + 8 : off + 8 + frame_n]
                            )
                            results[i] = (chunk, fbytes or None)
                        elif with_mask:
                            mask = np.frombuffer(
                                body, np.uint8, chunk.rows, off
                            ).astype(bool)
                            results[i] = (chunk, mask)
                        else:
                            results[i] = chunk
                    else:
                        raise PoolBroken(
                            bytes(body).decode("utf-8", "replace")
                        )
            except (EOFError, OSError, IndexError, PoolBroken) as e:
                errors.append(e)

        threads = [
            threading.Thread(target=run, args=(w,), daemon=True)
            for w in range(width)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise PoolBroken(str(errors[0]))
        return results

    def _run_frames(
        self, op: int, frames: list[bytes], stats: _OpStats | None = None
    ) -> list[bytes]:
        """Fan pre-packed write-op frames across the workers (round-robin
        by index, like :meth:`_run_op`) and collect per-frame reply bytes
        in request order. Raises :class:`PoolBroken` on infrastructure
        failure, :class:`PayloadError` when any chunk's compute failed —
        the caller's serial arm re-raises the real exception in context."""
        results: list = [None] * len(frames)
        width = min(self.width, len(frames))
        infra: list[BaseException] = []
        payload: list[str] = []

        def run(w: int) -> None:
            try:
                for i in range(w, len(frames), width):
                    st, body = self._round_trip(w, op, frames[i], stats)
                    if st == _ST_OK:
                        results[i] = bytes(body)
                    elif st == _ST_DECODE_ERR:
                        payload.append(bytes(body).decode("utf-8", "replace"))
                        return
                    else:
                        raise PoolBroken(bytes(body).decode("utf-8", "replace"))
            except (EOFError, OSError, IndexError, PoolBroken) as e:
                infra.append(e)

        threads = [
            threading.Thread(target=run, args=(w,), daemon=True)
            for w in range(width)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if infra:
            raise PoolBroken(str(infra[0]))
        if payload:
            raise PayloadError(payload[0])
        return results

    def encode_submit_many(self, frames: list[bytes]) -> list[bytes] | None:
        """Pre-packed submit frames (:func:`writeops.pack_submit_frame`)
        → serialized ``SubmitJobsRequest`` bytes per frame, request
        order, or ``None`` when the caller must encode inline — pool
        unavailable, broken (remembered), or a payload failure (the
        serial arm surfaces the real error)."""
        if not frames:
            return []
        if not self._ensure():
            return None
        stats = _OpStats()
        t0 = time.perf_counter()
        try:
            out = self._run_frames(_OP_ENCODE_SUBMIT, frames, stats)
            _fold_op("encode_submit", stats, time.perf_counter() - t0)
            return out
        except PoolBroken as e:
            log.warning(
                "colpool broken; write ops inline from now on: %s", e
            )
            self._break()
            return None
        except PayloadError as e:
            log.warning(
                "colpool submit-encode payload failure; "
                "serial arm re-runs: %s", e,
            )
            return None

    def start_frames(self, op: int, chunks: list, pack_fn) -> _WriteJob | None:
        """Kick a write-op fan-out WITHOUT blocking: ``pack_fn(chunk)``
        builds each request frame on the fan-out threads, so the caller
        (holding a store lock, say) overlaps the whole pack + round-trip
        with its own work and collects via ``handle.wait()``. Returns
        ``None`` when the pool can't start — the caller runs its serial
        arm at collect time, same as a ``wait() is None``."""
        if not chunks or not self._ensure():
            return None
        return _WriteJob(self, op, chunks, pack_fn)

    def decode_jobs_info_many(self, blobs: list[bytes]) -> list:
        """Decode each blob in a worker; per-blob JobsInfoChunk or
        DecodeError, request order. Falls back to the inline serial
        decode (and stays there) on any pool-infrastructure failure."""
        if not blobs:
            return []
        if not self._ensure():
            return decode_serial(blobs)
        stats = _OpStats()
        t0 = time.perf_counter()
        try:
            out = self._run_op(_OP_DECODE, blobs, with_mask=False, stats=stats)
            _fold_op("decode", stats, time.perf_counter() - t0)
            return out
        except PoolBroken as e:
            log.warning("colpool broken; decoding inline from now on: %s", e)
            self._break()
            return decode_serial(blobs)

    def decode_diff_many(self, blobs: list[bytes], prior: dict) -> list:
        """Decode + signal-diff each blob in a worker: per-blob
        ``(JobsInfoChunk, changed mask)`` or DecodeError, request order.
        ``prior`` is shipped once per participating worker, then each
        chunk diffs against it in-process — the "decode plus mirror
        diff" op of ISSUE 16."""
        if not blobs:
            return []
        if not self._ensure():
            return [
                r if isinstance(r, coldec.DecodeError)
                else (r, diff_signals(r, prior))
                for r in decode_serial(blobs)
            ]
        stats = _OpStats()
        t0 = time.perf_counter()
        try:
            pbody = _pack_prior(prior)
            width = min(self.width, len(blobs))
            for w in range(width):
                st, body = self._round_trip(w, _OP_SET_PRIOR, pbody, stats)
                if st != _ST_OK:
                    raise PoolBroken(bytes(body).decode("utf-8", "replace"))
            out = self._run_op(
                _OP_DECODE_DIFF, blobs, with_mask=True, stats=stats
            )
            _fold_op("decode_diff", stats, time.perf_counter() - t0)
            return out
        except (PoolBroken, EOFError, OSError) as e:
            # raw pipe death in the SET_PRIOR round-trips (workers died
            # between ops) is the same infra failure _run_op reports as
            # PoolBroken — remember it and run the inline arm
            log.warning("colpool broken; decoding inline from now on: %s", e)
            self._break()
            return [
                r if isinstance(r, coldec.DecodeError)
                else (r, diff_signals(r, prior))
                for r in decode_serial(blobs)
            ]

    def decode_diff_frames_many(
        self, blobs: list[bytes], prior: dict
    ) -> list | None:
        """Decode + diff each blob in a worker AND pack the commit frame
        for its changed rows: per-blob ``(JobsInfoChunk, frame bytes or
        None)`` or DecodeError, request order. Returns ``None`` when the
        pool can't serve — unavailable or broken (remembered) — and the
        caller runs its frameless arm (``decode_jobs_info_many`` degrades
        further to inline serial decode, so mid-tick breakage completes
        the tick on the inline arm)."""
        if not blobs:
            return []
        if not self._ensure():
            return None
        stats = _OpStats()
        t0 = time.perf_counter()
        try:
            pbody = _pack_prior(prior)
            width = min(self.width, len(blobs))
            for w in range(width):
                st, body = self._round_trip(w, _OP_SET_PRIOR, pbody, stats)
                if st != _ST_OK:
                    raise PoolBroken(bytes(body).decode("utf-8", "replace"))
            out = self._run_op(
                _OP_DIFF_FRAMES, blobs, with_mask=False, with_frame=True,
                stats=stats,
            )
            _fold_op("diff_frames", stats, time.perf_counter() - t0)
            return out
        except (PoolBroken, EOFError, OSError) as e:
            log.warning("colpool broken; decoding inline from now on: %s", e)
            self._break()
            return None

    def worker_metrics(self, w: int = 0) -> dict | None:
        """Counter snapshot from worker ``w``'s own post-fork registry
        (``{"pid": ..., "counters": {...}}``) — the fork-hygiene probe:
        a freshly forked worker must NOT report the parent's inherited
        totals. Returns ``None`` when the pool can't serve."""
        if not self._ensure() or w >= self.width:
            return None
        try:
            st, body = self._round_trip(w, _OP_METRICS, b"")
            if st != _ST_OK:
                return None
            return json.loads(bytes(body).decode("utf-8"))
        except (EOFError, OSError) as e:
            log.warning("colpool broken; metrics probe failed: %s", e)
            self._break()
            return None


# ---- process-wide pool -------------------------------------------------

_pool: ColPool | None = None
_pool_width: int | None = None
_pool_lock = threading.Lock()


def configured_width() -> int:
    """Worker count: ``SBT_COLPOOL_WORKERS`` when set (0 disables),
    else CPU-affinity cores minus one — the main process keeps a core
    for the diff/write half of the mirror. ≤1 available core means 0:
    forking a worker that time-slices against the parent would be pure
    overhead, so the pool degrades to the inline serial path."""
    env = os.environ.get("SBT_COLPOOL_WORKERS")
    if env is not None:
        try:
            return max(0, int(env))
        except ValueError:
            return 0
    if not hasattr(os, "fork"):  # pragma: no cover - non-posix
        return 0
    try:
        cores = len(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # pragma: no cover - non-linux
        cores = os.cpu_count() or 1
    return max(0, cores - 1)


def active_pool() -> ColPool | None:
    """The process-wide pool, or None when the configured width is 0
    (the caller runs the serial path inline — zero pool overhead)."""
    global _pool, _pool_width
    width = configured_width()
    if width <= 0:
        return None
    with _pool_lock:
        if _pool is None or _pool_width != width:
            if _pool is not None:
                _pool.close()
            _pool = ColPool(width)
            _pool_width = width
        return _pool


def reset() -> None:
    """Tear down the process pool (tests; also runs at exit)."""
    global _pool, _pool_width
    with _pool_lock:
        if _pool is not None:
            _pool.close()
        _pool = None
        _pool_width = None


atexit.register(reset)
