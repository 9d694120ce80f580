"""Native Linux inotify, via ctypes against libc — no vendored deps.

Reference parity: pkg/tail/watch/inotify.go:133 + inotify_tracker.go:246
(fsnotify-backed watching with a polling fallback, watch/polling.go:117).
The rebuild binds the same kernel facility directly: ``inotify_init1`` /
``inotify_add_watch`` / ``read`` on the event fd, plus a self-pipe so
waiters can be woken for shutdown. Callers fall back to polling when
:func:`available` is False (non-Linux, or the syscalls missing).
"""

from __future__ import annotations

import ctypes
import errno
import os
import select
import struct
import threading

# <sys/inotify.h> event masks
IN_ACCESS = 0x0001
IN_MODIFY = 0x0002
IN_ATTRIB = 0x0004
IN_CLOSE_WRITE = 0x0008
IN_MOVED_FROM = 0x0040
IN_MOVED_TO = 0x0080
IN_CREATE = 0x0100
IN_DELETE = 0x0200
IN_DELETE_SELF = 0x0400
IN_MOVE_SELF = 0x0800
IN_IGNORED = 0x8000

#: everything a log-follower cares about: growth, rotation, replacement
TAIL_MASK = (
    IN_MODIFY
    | IN_ATTRIB
    | IN_CLOSE_WRITE
    | IN_MOVED_FROM
    | IN_MOVED_TO
    | IN_CREATE
    | IN_DELETE
    | IN_DELETE_SELF
    | IN_MOVE_SELF
)

_IN_NONBLOCK = os.O_NONBLOCK
_IN_CLOEXEC = getattr(os, "O_CLOEXEC", 0)

_EVENT_HDR = struct.Struct("iIII")  # wd, mask, cookie, len


def _libc():
    return ctypes.CDLL(None, use_errno=True)


def available() -> bool:
    """True when the kernel + libc expose inotify (Linux)."""
    try:
        lib = _libc()
        lib.inotify_init1
        lib.inotify_add_watch
    except (OSError, AttributeError):
        return False
    return True


class Inotify:
    """A single inotify instance watching one or more paths.

    :meth:`wait` blocks until an event arrives for a watched path (or the
    timeout elapses, or :meth:`wake` is called) and returns the decoded
    ``(mask, name)`` pairs. Thread-safe for one waiter + external wakers.
    """

    def __init__(self):
        lib = _libc()
        fd = lib.inotify_init1(_IN_NONBLOCK | _IN_CLOEXEC)
        if fd < 0:
            raise OSError(ctypes.get_errno(), "inotify_init1 failed")
        self._lib = lib
        self.fd = fd
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        self._wds: dict[int, str] = {}
        self._closed = False
        self._lock = threading.Lock()

    def add_watch(self, path: str, mask: int = TAIL_MASK) -> int:
        wd = self._lib.inotify_add_watch(self.fd, path.encode(), mask)
        if wd < 0:
            raise OSError(ctypes.get_errno(), f"inotify_add_watch({path!r}) failed")
        with self._lock:
            self._wds[wd] = path
        return wd

    def rm_watch(self, wd: int) -> None:
        with self._lock:
            self._wds.pop(wd, None)
        self._lib.inotify_rm_watch(self.fd, wd)

    def wake(self) -> None:
        """Unblock a concurrent :meth:`wait` (shutdown path)."""
        try:
            os.write(self._wake_w, b"x")
        except OSError:
            pass

    def _drain(self) -> list[tuple[int, str]]:
        events: list[tuple[int, str]] = []
        while True:
            try:
                buf = os.read(self.fd, 65536)
            except BlockingIOError:
                break
            except OSError as e:
                if e.errno == errno.EBADF:
                    break
                raise
            off = 0
            while off + _EVENT_HDR.size <= len(buf):
                _wd, mask, _cookie, nlen = _EVENT_HDR.unpack_from(buf, off)
                off += _EVENT_HDR.size
                name = buf[off: off + nlen].split(b"\0", 1)[0].decode(
                    "utf-8", "replace"
                )
                off += nlen
                events.append((mask, name))
        return events

    def wait(self, timeout: float | None) -> list[tuple[int, str]]:
        """Block up to ``timeout`` seconds; returns decoded events (possibly
        empty on timeout or wake)."""
        if self._closed:
            return []
        try:
            ready, _, _ = select.select([self.fd, self._wake_r], [], [], timeout)
        except (OSError, ValueError):
            return []
        if self._wake_r in ready:
            try:
                while os.read(self._wake_r, 4096):
                    pass
            except (BlockingIOError, OSError):
                pass
        if self.fd in ready:
            return self._drain()
        return []

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.wake()
        for fd in (self.fd, self._wake_r, self._wake_w):
            try:
                os.close(fd)
            except OSError:
                pass
