"""Line-oriented file following with rotation handling and rate limiting.

Reference parity: the vendored hpcloud/tail fork (pkg/tail, SURVEY.md
§2.8): ``Config`` with Follow/ReOpen/Poll/MaxLineSize/RateLimiter
(tail.go:56-72), truncation restart, reopen-on-rotation (``tail -F``),
and the leaky-bucket rate limiter (ratelimiter/leakybucket.go:97). Like
the reference's inotify watcher with polling fallback
(watch/inotify.go:133, watch/polling.go:117), waiting for growth is
event-driven through native inotify (:mod:`slurm_bridge_tpu_torch.utils.inotify`)
when the kernel provides it, with the 250ms polling cadence as fallback
(``TailConfig.poll`` forces either mode, mirroring Config.Poll).
"""

from __future__ import annotations

import io
import os
import threading
import time
from dataclasses import dataclass, field

from slurm_bridge_tpu_torch.utils import inotify as _inotify


class LeakyBucket:
    """Token bucket: ``capacity`` tokens, one regenerated every ``interval``
    seconds (ratelimiter/leakybucket.go's semantics — a *pour* takes a
    token; an empty bucket means throttle)."""

    def __init__(self, capacity: int, interval: float):
        self.capacity = capacity
        self.interval = interval
        self._level = float(capacity)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def pour(self, n: int = 1) -> bool:
        """Take n tokens; False (throttled) if not available."""
        with self._lock:
            now = time.monotonic()
            if self.interval > 0:
                self._level = min(
                    float(self.capacity), self._level + (now - self._last) / self.interval
                )
            self._last = now
            if self._level >= n:
                self._level -= n
                return True
            return False

    def wait_time(self, n: int = 1) -> float:
        with self._lock:
            deficit = n - self._level
        return max(0.0, deficit * self.interval)


@dataclass
class TailConfig:
    """tail.Config equivalent (tail.go:56-72)."""

    follow: bool = True          # Follow: keep reading as the file grows
    reopen: bool = False         # ReOpen: tail -F across rotations
    poll_interval: float = 0.25  # watch/polling.go's 250ms cadence
    max_line_size: int = 0       # 0 = unlimited; longer lines are split
    from_end: bool = False       # start at EOF (Location{0, io.SeekEnd})
    rate_limiter: LeakyBucket | None = None
    #: Config.Poll equivalent: True forces mtime polling, False forces
    #: inotify (raises where unavailable), None = auto (inotify on Linux).
    poll: bool | None = None


@dataclass
class Line:
    """A tailed line (tail.Line): text without the newline + read time."""

    text: str
    time: float = field(default_factory=time.time)
    err: str = ""


class Tail:
    """Iterate lines of a (possibly growing, possibly rotating) file.

    ``for line in Tail(path, TailConfig(...)):`` yields :class:`Line`s;
    the iterator ends when follow is off and EOF is reached, when the file
    vanishes with reopen off, or when :meth:`stop` is called. A throttled
    tail emits a ``Line(err="rate limit exceeded...")`` marker and pauses,
    like the reference's leaky-bucket handling in tail.go.
    """

    def __init__(self, path: str, config: TailConfig | None = None):
        self.path = path
        self.config = config or TailConfig()
        self._stop = threading.Event()
        self._fh: io.BufferedReader | None = None
        self._ino: int | None = None
        self._buf = b""
        self._watch: _inotify.Inotify | None = None
        if self.config.poll is True:
            self._want_inotify = False
        elif self.config.poll is False:
            if not _inotify.available():
                raise RuntimeError("inotify forced (poll=False) but unavailable")
            self._want_inotify = True
        else:
            self._want_inotify = _inotify.available()

    def stop(self) -> None:
        self._stop.set()
        if self._watch is not None:
            self._watch.wake()

    # -- change waiting ---------------------------------------------------
    def _wait_for_change(self, timeout: float) -> bool:
        """Block until the file plausibly changed, the timeout elapsed, or
        stop was requested; returns True only for stop.

        The inotify mode watches the parent DIRECTORY (the reference's
        inotify_tracker does the same) so creation and rotation of the
        target name wake the tail even while the file doesn't exist. Events
        for other names in the directory are filtered out. The timeout is
        kept as a safety net — a missed event costs one polling interval,
        never correctness.
        """
        if self._want_inotify and self._watch is None:
            try:
                w = _inotify.Inotify()
                w.add_watch(os.path.dirname(self.path) or ".")
                self._watch = w
            except OSError:
                self._want_inotify = False  # dir gone/odd fs: poll instead
        if self._watch is None:
            return self._stop.wait(timeout)
        base = os.path.basename(self.path)
        deadline = time.monotonic() + timeout
        while not self._stop.is_set():
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            events = self._watch.wait(remaining)
            if self._stop.is_set():
                break
            if not events:
                break  # timeout — fall through to the regular re-check
            if any(name in ("", base) for _mask, name in events):
                break  # our file (or the dir itself) changed
        return self._stop.is_set()

    # -- file lifecycle ---------------------------------------------------
    def _open(self, *, initial: bool) -> bool:
        try:
            fh = open(self.path, "rb")
        except OSError:
            return False
        self._fh = fh
        try:
            self._ino = os.fstat(fh.fileno()).st_ino
        except OSError:
            self._ino = None
        if initial and self.config.from_end:
            fh.seek(0, os.SEEK_END)
        return True

    def _rotated(self) -> bool:
        """True when the path now names a different file (rotation) or the
        current file shrank (truncation)."""
        assert self._fh is not None
        try:
            st_path = os.stat(self.path)
        except OSError:
            return True  # vanished; reopen will retry
        if self._ino is not None and st_path.st_ino != self._ino:
            return True
        return st_path.st_size < self._fh.tell()

    def _close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._buf = b""

    # -- iteration --------------------------------------------------------
    def __iter__(self):
        cfg = self.config
        opened_before = False
        try:
            while not self._stop.is_set():
                if self._fh is None:
                    if not self._open(initial=not opened_before):
                        if opened_before and not cfg.reopen:
                            return  # our file was rotated away, reopen off
                        if not cfg.follow and not cfg.reopen:
                            return
                        # follow: block until the file appears (tail -f)
                        if self._wait_for_change(cfg.poll_interval):
                            return
                        continue
                    opened_before = True
                chunk = self._fh.read(65536)
                if chunk:
                    self._buf += chunk
                    yield from self._drain_lines()
                    continue
                # EOF. Truncation/rotation checks, then follow-or-finish.
                if self._rotated():
                    if cfg.reopen:
                        self._close()
                        continue
                    # plain truncation with reopen off: restart from the top,
                    # like the reference's pure-truncate handling; drop any
                    # partial line buffered from the pre-truncation file
                    try:
                        if os.stat(self.path).st_ino == self._ino:
                            self._fh.seek(0)
                            self._buf = b""
                            continue
                    except OSError:
                        pass
                    break
                if not cfg.follow:
                    break
                if self._wait_for_change(cfg.poll_interval):
                    break
            # emit any unterminated final line
            if self._buf:
                yield from self._emit(self._buf)
                self._buf = b""
        finally:
            self._close()
            self._close_watch()

    def _close_watch(self) -> None:
        if self._watch is not None:
            self._watch.close()
            self._watch = None

    def _drain_lines(self):
        while True:
            nl = self._buf.find(b"\n")
            if nl < 0:
                # oversize handling without a newline in sight
                if self.config.max_line_size and len(self._buf) >= self.config.max_line_size:
                    piece, self._buf = (
                        self._buf[: self.config.max_line_size],
                        self._buf[self.config.max_line_size:],
                    )
                    yield from self._emit(piece)
                    continue
                return
            line, self._buf = self._buf[:nl], self._buf[nl + 1:]
            yield from self._emit(line)

    def _emit(self, raw: bytes):
        cfg = self.config
        pieces = [raw]
        if cfg.max_line_size and len(raw) > cfg.max_line_size:
            pieces = [
                raw[i: i + cfg.max_line_size]
                for i in range(0, len(raw), cfg.max_line_size)
            ]
        for piece in pieces:
            if cfg.rate_limiter is not None and not cfg.rate_limiter.pour():
                yield Line(text="", err="rate limit exceeded, waiting for more tokens")
                wait = cfg.rate_limiter.wait_time()
                deadline = time.monotonic() + wait
                while not self._stop.is_set() and time.monotonic() < deadline:
                    if cfg.rate_limiter.pour():
                        break
                    self._stop.wait(min(0.05, cfg.poll_interval))
                else:
                    if self._stop.is_set():
                        return
            yield Line(text=piece.decode("utf-8", "replace"))


def tail_lines(path: str, **config_kwargs):
    """Convenience: iterate Line.text for a finite (non-follow) read."""
    cfg = TailConfig(follow=False, **config_kwargs)
    for line in Tail(path, cfg):
        if not line.err:
            yield line.text
