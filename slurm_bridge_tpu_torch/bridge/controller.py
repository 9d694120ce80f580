"""Level-triggered controller runtime: work queue + worker pool.

Reference parity: controller-runtime's manager/reconciler loop
(slurmbridgejob_controller.go:184-209 SetupWithManager,
MaxConcurrentReconciles :185-188) and the virtual-kubelet pod-sync worker
pool (PodSyncWorkers, options.go:107). Semantics kept:

- keys are deduplicated while queued (reconciling is level-triggered: a
  burst of watch events collapses into one reconcile of current state);
- a failed reconcile is requeued with per-key exponential backoff
  (workqueue.DefaultControllerRateLimiter equivalent);
- ``requeue_after`` supports the operator's 30s result-poll requeue
  (slurmbridgejob_controller.go:141).
"""

from __future__ import annotations

import heapq
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from slurm_bridge_tpu_torch.obs.metrics import REGISTRY

log = logging.getLogger("sbt.controller")

_queue_depth = REGISTRY.gauge(
    "sbt_controller_queue_depth", "keys queued (ready + delayed) per work queue"
)


@dataclass
class Result:
    """Reconcile outcome (ctrl.Result equivalent)."""

    requeue_after: float = 0.0


class WorkQueue:
    """Deduplicating delayed work queue with per-key backoff."""

    def __init__(
        self, *, base_delay: float = 0.005, max_delay: float = 30.0,
        name: str = "workqueue",
    ):
        self._lock = threading.Condition()
        self._queued: set[str] = set()
        #: deque, not list: a cold-start storm parks tens of thousands of
        #: keys here and ``pop(0)`` on a list is O(n) — quadratic drain
        self._ready: deque[str] = deque()
        self._delayed: list[tuple[float, str]] = []  # heap of (when, key)
        self._failures: dict[str, int] = {}
        self._base = base_delay
        self._max = max_delay
        self._shutdown = False
        self._depth_set = None  # bound gauge setter, built per name
        self.name = name

    @property
    def name(self) -> str:
        return self._name

    @name.setter
    def name(self, value: str) -> None:
        self._name = value
        self._depth_set = None  # re-bind the gauge label on rename

    def _observe_depth(self) -> None:
        """Caller holds the lock. The gauge setter is bound once per
        queue name (label-tuple built once, not per add/pop)."""
        setter = self._depth_set
        if setter is None:
            setter = self._depth_set = _queue_depth.handle(queue=self._name)
        setter(len(self._ready) + len(self._delayed))

    def add(self, key: str) -> None:
        with self._lock:
            if key in self._queued or self._shutdown:
                return
            self._queued.add(key)
            self._ready.append(key)
            self._observe_depth()
            self._lock.notify()

    def add_after(self, key: str, delay: float) -> None:
        if delay <= 0:
            return self.add(key)
        with self._lock:
            if self._shutdown:
                return
            heapq.heappush(self._delayed, (time.monotonic() + delay, key))
            self._observe_depth()
            self._lock.notify()

    def add_rate_limited(self, key: str) -> None:
        with self._lock:
            n = self._failures.get(key, 0)
            self._failures[key] = n + 1
        self.add_after(key, min(self._max, self._base * (2**n)))

    def forget(self, key: str) -> None:
        with self._lock:
            self._failures.pop(key, None)

    def get(self, timeout: float | None = None) -> str | None:
        """Block for the next ready key; None on shutdown/timeout."""
        deadline = time.monotonic() + timeout if timeout is not None else None
        with self._lock:
            while True:
                now = time.monotonic()
                while self._delayed and self._delayed[0][0] <= now:
                    _, key = heapq.heappop(self._delayed)
                    if key not in self._queued:
                        self._queued.add(key)
                        self._ready.append(key)
                if self._ready:
                    key = self._ready.popleft()
                    self._queued.discard(key)
                    self._observe_depth()
                    return key
                if self._shutdown:
                    return None
                wait = None
                if self._delayed:
                    wait = max(0.0, self._delayed[0][0] - now)
                if deadline is not None:
                    remaining = deadline - now
                    if remaining <= 0:
                        return None
                    wait = remaining if wait is None else min(wait, remaining)
                self._lock.wait(wait)

    def shut_down(self) -> None:
        with self._lock:
            self._shutdown = True
            self._lock.notify_all()

    def __len__(self) -> int:
        with self._lock:
            return len(self._ready) + len(self._delayed)


@dataclass
class Controller:
    """Runs ``reconcile(key) -> Result | None`` over a worker pool."""

    name: str
    reconcile: object  # Callable[[str], Result | None]
    workers: int = 1
    queue: WorkQueue = field(default_factory=WorkQueue)
    _threads: list[threading.Thread] = field(default_factory=list)

    def __post_init__(self) -> None:
        if self.queue.name == "workqueue":  # default-built: adopt our name
            self.queue.name = self.name

    def start(self) -> None:
        for i in range(self.workers):
            t = threading.Thread(
                target=self._run, name=f"{self.name}-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)

    def _run(self) -> None:
        from slurm_bridge_tpu_torch.obs.tracing import TRACER

        while True:
            key = self.queue.get()
            if key is None:
                return
            try:
                with TRACER.span(f"{self.name}.reconcile", key=key):
                    result = self.reconcile(key)
            except Exception:
                log.exception("%s: reconcile %s failed", self.name, key)
                self.queue.add_rate_limited(key)
                continue
            self.queue.forget(key)
            if result is not None and result.requeue_after > 0:
                self.queue.add_after(key, result.requeue_after)

    def enqueue(self, key: str) -> None:
        self.queue.add(key)

    def stop(self, timeout: float = 5.0) -> None:
        self.queue.shut_down()
        for t in self._threads:
            t.join(timeout)


class Ticker:
    """A stoppable interval loop (the configurator/scheduler tickers,
    configurator.go:94-118)."""

    def __init__(self, interval: float, fn, *, name: str = "ticker"):
        self.interval = interval
        self.fn = fn
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name=name, daemon=True)

    def start(self) -> "Ticker":
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.fn()
            except Exception:
                log.exception("ticker %s failed", self._thread.name)
            self._stop.wait(self.interval)

    def trigger_now(self) -> None:
        """Run one tick synchronously (tests / forced convergence)."""
        self.fn()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(5.0)
