"""Event recorder — the user-facing audit trail.

Reference parity: K8s Events with the reason taxonomy of
pkg/common/status.go:14-35 and cmd events/event.go:20-60 (the reference
leans on recorder.Eventf as its audit trail — SURVEY.md §5). Here events
are structured records kept in a ring buffer and logged; the kube layer
mirrors them onto objects so `describe` shows them.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import NamedTuple


class Reason:
    """Event reason taxonomy (kind-prefixed like the reference's NewReason
    helper, common/status.go:37-39)."""

    # job lifecycle
    JOB_CREATED = "SlurmBridgeJobCreated"
    JOB_SUBMITTED = "SlurmBridgeJobSubmitted"
    JOB_RUNNING = "SlurmBridgeJobRunning"
    JOB_SUCCEEDED = "SlurmBridgeJobSucceeded"
    JOB_FAILED = "SlurmBridgeJobFailed"
    JOB_CANCELLED = "SlurmBridgeJobCancelled"
    # placement
    PLACEMENT_OK = "PlacementSucceeded"
    PLACEMENT_FAILED = "PlacementFailed"
    # pods / virtual nodes
    POD_CREATED = "PodCreated"
    POD_FAILED = "PodFailed"
    POD_PENDING = "PodPendingRetry"
    NODE_READY = "VirtualNodeReady"
    NODE_GONE = "VirtualNodeGone"
    # results
    RESULT_FETCH_STARTED = "ResultFetchStarted"
    RESULT_FETCH_DONE = "ResultFetchSucceeded"
    RESULT_FETCH_FAILED = "ResultFetchFailed"


class Event(NamedTuple):
    """A NamedTuple, not a dataclass: the recorder mints ~100k of these
    per cold-start reconcile tick and C-level construction matters."""

    reason: str
    message: str
    kind: str = ""
    name: str = ""
    type: str = "Normal"  # Normal | Warning
    ts: float = 0.0


class EventRecorder:
    def __init__(self, *, capacity: int = 1024, logger: str = "sbt.events"):
        self._events: deque[Event] = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._log = logging.getLogger(logger)
        self._sinks: list = []

    def add_sink(self, fn) -> None:
        """fn(Event) — e.g. the kube layer appending to object events."""
        self._sinks.append(fn)

    def event(self, obj, reason: str, message: str, *, warning: bool = False) -> Event:
        return self.emit(
            type(obj).__name__ if obj is not None else "",
            getattr(obj, "name", "") if obj is not None else "",
            reason,
            message,
            warning=warning,
        )

    def emit(
        self, kind: str, name: str, reason: str, message: str,
        *, warning: bool = False,
    ) -> Event:
        """The object-free form: columnar hot paths (bind, batched
        submit, sweep) record events without materializing a frozen view
        just to read its kind and name."""
        ev = Event(
            reason=reason,
            message=message,
            kind=kind,
            name=name,
            type="Warning" if warning else "Normal",
            ts=time.time(),
        )
        with self._lock:
            self._events.append(ev)
        # isEnabledFor before the log call: the simulator/benchmarks quiet
        # this logger and emit ~100k events per cold-start tick — skipping
        # the no-op logging machinery is a real win there
        level = logging.WARNING if warning else logging.INFO
        if self._log.isEnabledFor(level):
            self._log.log(
                level, "%s %s/%s: %s", ev.reason, ev.kind, ev.name, ev.message
            )
        for sink in self._sinks:
            sink(ev)
        return ev

    def emit_batch(
        self,
        kind: str,
        reason: str,
        pairs: list[tuple[str, str]],
        *,
        warning: bool = False,
    ) -> None:
        """Many events of one (kind, reason) in one pass — ONE lock
        acquisition, one logger-level probe, one timestamp (the batch is
        one logical commit; consumers key on reason/name, not ts). The
        columnar hot paths emit 45k+ events per cold tick; the per-event
        lock/log overhead was a visible slice of the bind phase."""
        if not pairs:
            return
        t = "Warning" if warning else "Normal"
        now = time.time()
        evs = [
            Event(reason=reason, message=msg, kind=kind, name=nm,
                  type=t, ts=now)
            for nm, msg in pairs
        ]
        with self._lock:
            self._events.extend(evs)
        level = logging.WARNING if warning else logging.INFO
        if self._log.isEnabledFor(level):
            for ev in evs:
                self._log.log(
                    level, "%s %s/%s: %s",
                    ev.reason, ev.kind, ev.name, ev.message,
                )
        for sink in self._sinks:
            for ev in evs:
                sink(ev)

    def events(self, *, name: str | None = None) -> list[Event]:
        with self._lock:
            evs = list(self._events)
        if name is not None:
            evs = [e for e in evs if e.name == name]
        return evs
