"""Typed clients, informers and listers over the object store.

Reference parity: the generated ``pkg/client/`` machinery — typed clientset
(clientset/versioned/), SharedInformerFactory (externalversions/factory.go:250)
and indexed listers — re-expressed over :class:`ObjectStore`. The pattern is
the same one controller-runtime builds on:

- a **TypedClient** narrows store CRUD to one object class;
- an **Informer** pumps the store's watch into a local read cache, fires
  add/update/delete handlers, and re-lists on a resync interval so
  level-triggered consumers recover from missed edges;
- a **lister** is the informer's cache read — no store round-trip, the
  same reason the reference reads through listers instead of the API
  server on every sync (pkg/slurm-virtual-kubelet/manager/resource.go).

The reference also ships a *fake* clientset for tests
(pkg/client/clientset/versioned/fake/); here the real ``ObjectStore`` is
already in-process and hermetic, so the fake and the real client are the
same object — tests construct a fresh store and go.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field

from slurm_bridge_tpu_torch.bridge.store import ObjectStore, StoreEvent

log = logging.getLogger("sbt.client")


class TypedClient:
    """CRUD for one object class (a typed clientset group).

    >>> jobs = TypedClient(store, BridgeJob)
    >>> jobs.create(job); jobs.get("demo"); jobs.list(labels={...})
    """

    def __init__(self, store: ObjectStore, cls: type):
        self._store = store
        self._cls = cls
        self.kind = cls.KIND

    def create(self, obj):
        return self._store.create(obj)

    def get(self, name: str):
        return self._store.get(self.kind, name)

    def try_get(self, name: str):
        return self._store.try_get(self.kind, name)

    def get_for_update(self, name: str):
        return self._store.get_for_update(self.kind, name)

    def update(self, obj):
        return self._store.update(obj)

    def mutate(self, name: str, fn, **kw):
        return self._store.mutate(self.kind, name, fn, **kw)

    def delete(self, name: str) -> None:
        self._store.delete(self.kind, name)

    def list(self, *, labels: dict[str, str] | None = None) -> list:
        return self._store.list(self.kind, labels=labels)


@dataclass
class _Handlers:
    on_add: object = None
    on_update: object = None
    on_delete: object = None


class Informer:
    """Watch-fed local cache with event handlers and periodic resync.

    The cache holds the store's latest copy of every object of one kind;
    ``lister()`` reads it without touching the store. ``resync_interval``
    re-fires on_update for every cached object, the resyncPeriod contract
    informer consumers rely on for missed-edge recovery (the reference's
    1-minute pod resync, options.go:105).
    """

    def __init__(self, store: ObjectStore, kind: str, *, resync_interval: float = 0.0):
        self._store = store
        self.kind = kind
        self._resync = resync_interval
        self._cache: dict[str, object] = {}
        self._lock = threading.RLock()
        self._handlers: list[_Handlers] = []
        self._queue = None
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.synced = threading.Event()

    # ---- handler registration (before or after start) ----

    def add_handlers(self, on_add=None, on_update=None, on_delete=None) -> None:
        h = _Handlers(on_add, on_update, on_delete)
        with self._lock:
            self._handlers.append(h)
            known = list(self._cache.values())
        for obj in known:  # late joiners see the current state as adds
            self._dispatch(h.on_add, obj)

    def _dispatch(self, fn, obj) -> None:
        if fn is None:
            return
        try:
            fn(obj)
        except Exception:
            log.exception("informer(%s): handler failed", self.kind)

    # ---- lifecycle ----

    def start(self) -> "Informer":
        self._queue = self._store.watch((self.kind,))
        self._thread = threading.Thread(
            target=self._run, name=f"informer-{self.kind}", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        import time

        next_resync = None
        if self._resync > 0:
            next_resync = time.monotonic() + self._resync
        while not self._stop.is_set():
            timeout = 0.2
            if next_resync is not None:
                timeout = min(timeout, max(0.0, next_resync - time.monotonic()))
            try:
                ev: StoreEvent = self._queue.get(timeout=timeout)
            except Exception:  # queue.Empty
                ev = None
            if ev is not None:
                self._apply(ev)
                if self._queue.empty():
                    self.synced.set()
            elif not self.synced.is_set():
                self.synced.set()
            if next_resync is not None and time.monotonic() >= next_resync:
                self._do_resync()
                next_resync = time.monotonic() + self._resync

    def _apply(self, ev: StoreEvent) -> None:
        if ev.type == "DELETED":
            with self._lock:
                obj = self._cache.pop(ev.name, None)
                handlers = list(self._handlers)
            if obj is not None:
                for h in handlers:
                    self._dispatch(h.on_delete, obj)
            return
        obj = self._store.try_get(self.kind, ev.name)
        if obj is None:  # deleted between event and read; DELETED follows
            return
        with self._lock:
            existed = ev.name in self._cache
            self._cache[ev.name] = obj
            handlers = list(self._handlers)
        for h in handlers:
            self._dispatch(h.on_update if existed else h.on_add, obj)

    def _do_resync(self) -> None:
        for obj in self._store.list(self.kind):
            with self._lock:
                self._cache[obj.meta.name] = obj
                handlers = list(self._handlers)
            for h in handlers:
                self._dispatch(h.on_update, obj)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
        if self._queue is not None:
            self._store.unwatch(self._queue)

    # ---- lister ----

    def lister(self, *, labels: dict[str, str] | None = None) -> list:
        """Cached list — no store round-trip."""
        with self._lock:
            out = list(self._cache.values())
        if labels:
            out = [
                o
                for o in out
                if all(o.meta.labels.get(k) == v for k, v in labels.items())
            ]
        return sorted(out, key=lambda o: o.meta.name)

    def cached(self, name: str):
        with self._lock:
            return self._cache.get(name)


class InformerFactory:
    """Shared informers, one per kind (SharedInformerFactory parity:
    externalversions/factory.go:250 — repeated requests return the same
    informer, Start launches them all, WaitForCacheSync blocks on all)."""

    def __init__(self, store: ObjectStore, *, resync_interval: float = 0.0):
        self._store = store
        self._resync = resync_interval
        self._informers: dict[str, Informer] = {}
        self._lock = threading.Lock()

    def informer_for(self, cls_or_kind) -> Informer:
        kind = getattr(cls_or_kind, "KIND", cls_or_kind)
        with self._lock:
            inf = self._informers.get(kind)
            if inf is None:
                inf = Informer(self._store, kind, resync_interval=self._resync)
                self._informers[kind] = inf
            return inf

    def start(self) -> None:
        with self._lock:
            for inf in self._informers.values():
                if inf._thread is None:
                    inf.start()

    def wait_for_cache_sync(self, timeout: float = 5.0) -> bool:
        with self._lock:
            infs = list(self._informers.values())
        return all(inf.synced.wait(timeout) for inf in infs)

    def stop(self) -> None:
        with self._lock:
            for inf in self._informers.values():
                inf.stop()
