"""EOF-masking file tailer.

Reference parity: pkg/common/tail/reader.go:25-92 — a reader whose Read
blocks through EOF while the file may still grow, until the caller asks for
"read to end and close" (the TailFile READ_TO_END_AND_CLOSE action,
api/slurm.go:240-295). The reference vendors an inotify fork (pkg/tail) for
this; a poll at the same 100 ms cadence the RPC loop already used
(api/slurm.go:267-269) needs no native watcher and behaves identically at
the wire.
"""

from __future__ import annotations

import os
import threading
import time


class TailReader:
    """Follow a file as it grows.

    ``read_chunk`` returns b"" only transiently (no new data yet) — the
    stream is over when :attr:`finished` is True: either :meth:`stop` was
    called (drain-to-end semantics) and the tail is consumed, or the file
    vanished.
    """

    def __init__(self, path: str, *, poll_interval: float = 0.1, chunk_size: int = 4096):
        self.path = path
        self.poll_interval = poll_interval
        self.chunk_size = chunk_size
        self._offset = 0
        self._stopping = threading.Event()
        self._finished = False

    def stop(self) -> None:
        """Switch to drain mode: emit what remains, then finish."""
        self._stopping.set()

    @property
    def finished(self) -> bool:
        return self._finished

    def read_chunk(self, *, block: bool = True) -> bytes:
        """Next chunk of new data; waits up to one poll interval if none."""
        while True:
            if self._finished:
                return b""
            try:
                size = os.path.getsize(self.path)
            except OSError:
                # file vanished: stream over
                self._finished = True
                return b""
            if size < self._offset:
                # truncated (e.g. log rotation): restart from the top,
                # matching tail's reopen behaviour
                self._offset = 0
                size = os.path.getsize(self.path)
            if size > self._offset:
                with open(self.path, "rb") as f:
                    f.seek(self._offset)
                    data = f.read(self.chunk_size)
                self._offset += len(data)
                return data
            if self._stopping.is_set():
                self._finished = True
                return b""
            if not block:
                return b""
            time.sleep(self.poll_interval)

    def __iter__(self):
        while True:
            chunk = self.read_chunk()
            if self._finished:
                return
            if chunk:
                yield chunk


def read_file_chunks(path: str, *, chunk_size: int = 65536):
    """One-shot streaming read (the OpenFile RPC body)."""
    with open(path, "rb") as f:
        while True:
            data = f.read(chunk_size)
            if not data:
                return
            yield data
