"""Filesystem seam + change watcher.

Reference parity: pkg/filesystem — a ``Filesystem`` interface so code that
touches disk is mockable (filesystem.go:26-52), a default implementation
with tempdir prefixing (defaultfs.go), and an fsnotify-style watcher
(watcher.go:24-48). The watcher here polls mtimes/existence (no native
inotify dependency) at a short interval — the same observable contract:
callbacks on create/modify/delete for registered paths.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading


class DefaultFs:
    """Real-filesystem implementation; ``root`` prefixes tempdirs so tests
    can sandbox everything the code writes (defaultfs.go's prefixing)."""

    def __init__(self, root: str = ""):
        self.root = root

    def read_file(self, path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()

    def write_file(self, path: str, data: bytes) -> None:
        with open(path, "wb") as f:
            f.write(data)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def mkdir_all(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def remove_all(self, path: str) -> None:
        shutil.rmtree(path, ignore_errors=True)

    def temp_dir(self, prefix: str) -> str:
        return tempfile.mkdtemp(prefix=prefix, dir=self.root or None)

    def temp_file(self, prefix: str) -> str:
        fd, path = tempfile.mkstemp(prefix=prefix, dir=self.root or None)
        os.close(fd)
        return path

    def list_dir(self, path: str) -> list[str]:
        return sorted(os.listdir(path))


class FsWatcher:
    """Poll-based file watcher: register paths, get callbacks on change.

    Events are ``("create"|"modify"|"delete", path)``. Start/stop mirrors
    the reference's FSWatcher lifecycle (watcher.go:24-48).
    """

    def __init__(self, handler, *, interval: float = 0.25):
        self.handler = handler
        self.interval = interval
        self._paths: dict[str, float | None] = {}  # path → last mtime (None = absent)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def add(self, path: str) -> None:
        with self._lock:
            self._paths[path] = self._stat(path)

    def remove(self, path: str) -> None:
        with self._lock:
            self._paths.pop(path, None)

    @staticmethod
    def _stat(path: str) -> float | None:
        try:
            return os.stat(path).st_mtime_ns
        except OSError:
            return None

    def _scan(self) -> None:
        with self._lock:
            snapshot = dict(self._paths)
        for path, last in snapshot.items():
            now = self._stat(path)
            if now == last:
                continue
            with self._lock:
                self._paths[path] = now
            if last is None:
                event = "create"
            elif now is None:
                event = "delete"
            else:
                event = "modify"
            try:
                self.handler(event, path)
            except Exception:
                import logging

                logging.getLogger("sbt.fswatch").exception(
                    "watch handler failed for %s", path
                )

    def start(self) -> "FsWatcher":
        self._thread = threading.Thread(target=self._run, name="fs-watcher", daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self._scan()

    def trigger_now(self) -> None:
        """One synchronous scan (tests / forced convergence)."""
        self._scan()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
