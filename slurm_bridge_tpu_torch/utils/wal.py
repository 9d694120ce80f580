"""Shared write-ahead-log machinery — framing, replay, durable appends.

Factored out of ``bridge/persist.py`` (PR-8) so the bridge's store WAL
and the agent's job-state journal (``agent/journal.py``) ride ONE
implementation of the on-disk contract:

- **Framing**: length-prefixed, CRC32-checksummed records
  (``<u32 len><u32 crc><json payload>``). The length word's high bit
  marks a zlib-compressed payload (:data:`COMPRESSED_FLAG`, PR-10) —
  old files can never set it, so replay stays format-compatible both
  ways. :func:`read_wal` detects a torn tail (crash mid-append —
  expected, not an error) or a corrupt record and returns everything
  before the first defect — prior state is never lost.
- **Group-commit fsync** (:class:`WalWriter`): appends are ordered under
  one lock; ``sync_to(offset)`` is the durability barrier. When several
  threads reach the barrier concurrently (the agent's batched-submit
  fan-out, a debounce flush racing ``close()``), ONE ``fsync`` covers
  every byte written before it started — callers whose offset is already
  durable return without syncing at all. ``fsyncs`` vs ``appends``
  exposes the batching ratio.
- **Disk-latency seam**: real fsyncs cost 1-5 ms on ordinary disks, but
  tests and the simulator run on page cache where they are nearly free —
  numbers measured there understate WAL overhead. A per-writer
  ``fsync_delay_s`` (or the process-wide :func:`set_fsync_delay`) adds a
  simulated device latency AFTER each real fsync, so
  ``benchmarks/ticksmoke.py --wal-fsync`` can measure the flush path at
  realistic latencies without needing a slow disk. The same seam covers
  :func:`utils.files.atomic_write` via :func:`durable_fsync`.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib

#: WAL record framing: little-endian (payload_len, crc32(payload))
RECORD_HDR = struct.Struct("<II")

#: high bit of the length word marks a zlib-compressed payload (PR-10).
#: Pre-compression files can never set it — a record would need 2 GiB of
#: JSON — so old WALs replay unchanged. The reverse direction is LOSSY:
#: an old reader treats the flagged length as a >2 GiB record and stops
#: at the first compressed frame as a "torn" tail, keeping only what
#: precedes it — so compact (fold the WAL into the snapshot) BEFORE
#: downgrading a binary across this format change. The CRC covers the
#: compressed bytes: corruption is detected before inflate ever runs.
COMPRESSED_FLAG = 0x8000_0000
_LEN_MASK = COMPRESSED_FLAG - 1

#: process-wide simulated fsync latency (seconds); per-writer override
#: takes precedence when set. See set_fsync_delay().
_FSYNC_DELAY_S = 0.0


def set_fsync_delay(seconds: float) -> float:
    """Set the process-wide simulated fsync latency; returns the previous
    value (so callers can restore it — the bench variant does)."""
    global _FSYNC_DELAY_S
    prev = _FSYNC_DELAY_S
    _FSYNC_DELAY_S = max(0.0, float(seconds))
    return prev


def fsync_delay() -> float:
    return _FSYNC_DELAY_S


def durable_fsync(fd: int, *, delay_s: float | None = None) -> None:
    """``os.fsync`` plus the injected device latency (per-call override,
    else the process-wide seam). Every durability barrier in the tree —
    WAL appends, snapshot installs, ``atomic_write`` — funnels through
    here so simulated disk latency covers all of them uniformly."""
    os.fsync(fd)
    d = _FSYNC_DELAY_S if delay_s is None else delay_s
    if d > 0.0:
        time.sleep(d)


def frame_body(body: bytes, *, compress: bool = False) -> bytes:
    """Frame an already-serialized JSON body. ``compress=True`` deflates
    it (zlib level 1 — the WAL is write-latency-bound, not ratio-bound)
    and sets the length word's :data:`COMPRESSED_FLAG`."""
    if compress:
        body = zlib.compress(body, 1)
        return RECORD_HDR.pack(
            len(body) | COMPRESSED_FLAG, zlib.crc32(body)
        ) + body
    return RECORD_HDR.pack(len(body), zlib.crc32(body)) + body


def pack_record(payload: dict, *, compress: bool = False) -> bytes:
    return frame_body(
        json.dumps(payload, separators=(",", ":")).encode(),
        compress=compress,
    )


def read_wal(path: str) -> tuple[list[dict], int, str | None]:
    """Parse a WAL file: ``(records, clean_bytes, defect)``.

    ``defect`` is None for a clean file, ``"torn"`` for a truncated last
    record (crash mid-append — expected, not an error), ``"corrupt"``
    for a checksum/JSON failure. Parsing stops at the first defect;
    everything before it is returned — prior state is never lost.
    """
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except FileNotFoundError:
        return [], 0, None
    records: list[dict] = []
    off, n = 0, len(data)
    while off < n:
        if off + RECORD_HDR.size > n:
            return records, off, "torn"
        word, crc = RECORD_HDR.unpack_from(data, off)
        length = word & _LEN_MASK
        end = off + RECORD_HDR.size + length
        if end > n:
            return records, off, "torn"
        body = data[off + RECORD_HDR.size : end]
        if zlib.crc32(body) != crc:
            return records, off, "corrupt"
        try:
            if word & COMPRESSED_FLAG:
                body = zlib.decompress(body)
            records.append(json.loads(body))
        except (ValueError, zlib.error):
            return records, off, "corrupt"
        off = end
    return records, off, None


class WalWriter:
    """Append-ordered WAL file with group-commit fsync.

    ``append`` writes under the append lock and returns the file offset
    AFTER the blob; ``sync_to(offset)`` makes everything up to that
    offset durable. Concurrent callers share fsyncs: whoever takes the
    sync token fsyncs the CURRENT end of file, and every waiter whose
    offset that covered returns without issuing its own — classic group
    commit, which is what keeps a 512-item batched submit from paying
    512 device flushes.

    ``fsync=False`` turns the barrier into a no-op (the simulator's
    within-process durability); ``fsync_delay_s`` injects simulated
    device latency per writer (None = follow the process-wide seam).
    The ``_fsync`` hook is injectable for tests (counting/fault fakes).
    """

    def __init__(
        self,
        path: str,
        *,
        fsync: bool = True,
        fsync_delay_s: float | None = None,
        _fsync=None,
    ):
        self.path = path
        self.fsync_enabled = fsync
        self.fsync_delay_s = fsync_delay_s
        self._do_fsync = _fsync
        self._fh = None
        self._append_lock = threading.Lock()
        self._state = threading.Condition()
        self._sync_in_flight = False
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        self._written = size
        self._synced = size
        #: observability: appended blobs vs device flushes (the group-
        #: commit batching ratio), total bytes appended this instance
        self.appends = 0
        self.fsyncs = 0
        self.bytes_appended = 0

    @property
    def size(self) -> int:
        return self._written

    def _file(self):
        if self._fh is None:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "ab")
        return self._fh

    def append(self, blob: bytes) -> int:
        """Append ``blob`` (ordered); returns the end offset to pass to
        :meth:`sync_to`. The write is flushed to the OS but NOT yet
        durable."""
        with self._append_lock:
            fh = self._file()
            fh.write(blob)
            fh.flush()
            self._written += len(blob)
            self.appends += 1
            self.bytes_appended += len(blob)
            return self._written

    def sync_to(self, offset: int) -> None:
        """Durability barrier: return once every byte up to ``offset`` is
        fsynced — or the WAL was truncated past it (a concurrent
        checkpoint folded those bytes into a durably-installed snapshot
        before truncating; without this check a waiter whose offset
        predates the truncate would spin forever against the reset
        counters). Group commit: one device flush covers every
        concurrent caller whose offset it reaches."""
        if not self.fsync_enabled:
            return
        while True:
            with self._state:
                if self._synced >= offset or offset > self._written:
                    return
                if self._sync_in_flight:
                    # someone else's fsync is running; it may cover us —
                    # wait for it to land, then re-check
                    self._state.wait()
                    continue
                self._sync_in_flight = True
            # we hold the sync token: flush up to the CURRENT end, so
            # writers that appended while we contended ride along free
            with self._append_lock:
                target = self._written
                fd = self._file().fileno()
            try:
                if self._do_fsync is not None:
                    self._do_fsync(fd)
                    d = (
                        fsync_delay()
                        if self.fsync_delay_s is None
                        else self.fsync_delay_s
                    )
                    if d > 0.0:
                        time.sleep(d)
                else:
                    durable_fsync(fd, delay_s=self.fsync_delay_s)
            except BaseException:
                # a FAILED fsync must not be recorded as durable: release
                # the token and wake waiters so each re-checks and issues
                # its own fsync (or propagates its own error) — advancing
                # _synced here would make every waiter report success for
                # bytes that never reached the device
                with self._state:
                    self._sync_in_flight = False
                    self._state.notify_all()
                raise
            with self._state:
                self._synced = max(self._synced, target)
                self._sync_in_flight = False
                self.fsyncs += 1
                self._state.notify_all()

    def append_durable(self, blob: bytes) -> int:
        """``append`` + ``sync_to`` in one call — the common record path."""
        end = self.append(blob)
        self.sync_to(end)
        return end

    def truncate(self) -> None:
        """Empty the WAL (compaction installed a snapshot covering it).
        Holds the sync token for the duration — an fsync racing the
        close would run on a dead fd — and wakes every waiter so
        pre-truncate offsets resolve via the snapshot-covered check in
        :meth:`sync_to`. Callers are responsible for excluding APPENDS
        across their snapshot-capture → truncate window (the journal's
        append barrier / persist's flush lock); an append that slipped
        in between would be destroyed uncovered."""
        with self._state:
            while self._sync_in_flight:
                self._state.wait()
            self._sync_in_flight = True  # block new fsyncs while we swap
        try:
            with self._append_lock:
                if self._fh is not None:
                    self._fh.close()
                    self._fh = None
                with open(self.path, "wb"):
                    pass
                with self._state:
                    self._written = 0
                    self._synced = 0
        finally:
            with self._state:
                self._sync_in_flight = False
                self._state.notify_all()

    def close(self) -> None:
        with self._append_lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
