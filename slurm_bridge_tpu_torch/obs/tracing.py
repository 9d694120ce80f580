"""Distributed tracing — spans, samplers, exporter registry, tracez page.

Reference parity: the VK's OpenCensus wiring (SURVEY.md §5): an exporter
registry (cmd/slurm-virtual-kubelet/app/options/tracing_register.go:37-58)
with pluggable backends (Jaeger tracing_register_jaeger.go:29-52, OC-agent
tracing_register_ocagent.go — here: log / json-file / in-memory), sampling
policies ``always|never|0-100`` (tracing.go:64-89), reserved service tags
(operatingSystem/provider/nodeName, tracing.go:33-38), and a zpages-style
``/debug/tracez`` debug view (tracing.go:94-114). Spans propagate through
threads explicitly (pass the parent) and within a thread implicitly via a
context variable, mirroring how the virtual-kubelet library wraps pod-sync
operations in spans.

Spans opened on the main thread while ``torch.profiler`` records also open
a profiler range of the same name, so the device trace's idle gaps are
named by what the tick's thread was doing; other threads' spans stay out
of it. A tracer can also keep a per-name tally of one thread's span
milliseconds for a block (:meth:`Tracer.tally`), which the simulator's tick
reads its phases from.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import logging
import os
import random
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field

log = logging.getLogger("sbt.trace")

_current_span: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "sbt_current_span", default=None
)

#: per-thread id generator, seeded ONCE from os.urandom — span/trace id
#: generation used to be one urandom syscall per id, the same per-object
#: cost PR-4 removed from ``new_uid`` (a 45k-bind tick with tracing on
#: would have paid 90k+ syscalls just for ids)
_id_local = threading.local()


def _new_id(nbytes: int) -> str:
    rng = getattr(_id_local, "rng", None)
    if rng is None:
        rng = _id_local.rng = random.Random(os.urandom(16))
    return rng.getrandbits(nbytes * 8).to_bytes(nbytes, "big").hex()


@dataclass(slots=True)
class Span:
    """One span. ``slots=True`` and lazy tag/annotation dicts keep
    construction cheap — the flight recorder opens spans inside the hot
    tick phases, so per-span cost is tick overhead. Spans mark phases and
    batches, never single objects: a per-object cost rides a counter on
    the batch's span."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str | None = None
    start: float = 0.0
    end: float = 0.0
    tags: dict = field(default_factory=dict)
    annotations: list = field(default_factory=list)
    status: str = "OK"
    sampled: bool = True
    #: numeric payload (rows decoded, commits written, pods scanned) —
    #: kept apart from the string ``tags`` so the flight recorder can
    #: aggregate without parsing, and ``count()`` stays a dict add
    counters: dict = field(default_factory=dict)
    #: monotonic start/stop pair — ``start``/``end`` stay wall-clock for
    #: OTLP export, but durations come from perf_counter so the flight
    #: recorder's phase arithmetic matches the perf-timed tick headline
    _mono0: float = 0.0
    _mono1: float = 0.0
    #: the parent Span OBJECT (not just its id) — children finish before
    #: their ancestors, so an exporter can resolve the full name path of
    #: a finishing span by walking this chain while the ancestors are
    #: still open. The flight recorder's per-path rollup (ISSUE 14)
    #: depends on it; never exported, never compared.
    parent: "Span | None" = None

    @property
    def duration(self) -> float:
        if self._mono0:
            return (self._mono1 or time.perf_counter()) - self._mono0
        return (self.end or time.time()) - self.start

    def annotate(self, message: str) -> None:
        self.annotations.append((time.time(), message))

    def set_tag(self, key: str, value) -> None:
        self.tags[key] = str(value)

    def count(self, key: str, n: float = 1.0) -> None:
        """Accumulate a numeric attribute on this span."""
        self.counters[key] = self.counters.get(key, 0.0) + n

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "traceId": self.trace_id,
            "spanId": self.span_id,
            "parentId": self.parent_id,
            "start": self.start,
            "durationMs": round(self.duration * 1e3, 3),
            "tags": self.tags,
            "counters": self.counters,
            "annotations": [
                {"t": t, "msg": m} for t, m in self.annotations
            ],
            "status": self.status,
        }


# --------------------------------------------------------------------------
# Samplers — policy grammar of tracing.go:64-89: "always", "never", or a
# percentage 0-100 interpreted as a probability.
# --------------------------------------------------------------------------

def parse_sampler(policy: str):
    """policy → () -> bool. Raises ValueError on nonsense (as the VK does)."""
    p = policy.strip().lower()
    if p in ("", "always"):
        return lambda: True
    if p == "never":
        return lambda: False
    try:
        rate = float(p)
    except ValueError:
        raise ValueError(
            f"unsupported tracing sample policy {policy!r} "
            "(want always|never|0-100)"
        ) from None
    if not 0 <= rate <= 100:
        raise ValueError(f"tracing sample rate {rate} outside [0,100]")
    frac = rate / 100.0
    return lambda: random.random() < frac


# --------------------------------------------------------------------------
# Exporters + registry
# --------------------------------------------------------------------------

class LogExporter:
    """Writes one structured log line per finished span."""

    def export(self, span: Span) -> None:
        log.info(
            "span %s trace=%s dur=%.1fms status=%s %s",
            span.name, span.trace_id[:8], span.duration * 1e3, span.status,
            " ".join(f"{k}={v}" for k, v in span.tags.items()),
        )


class JsonFileExporter:
    """Appends spans as JSON lines (the collector-friendly backend)."""

    DEFAULT_PATH = "/tmp/sbt-trace.jsonl"

    def __init__(self, path: str = DEFAULT_PATH):
        self.path = path
        self._lock = threading.Lock()

    def export(self, span: Span) -> None:
        line = json.dumps(span.to_dict(), separators=(",", ":"))
        with self._lock, open(self.path, "a") as fh:
            fh.write(line + "\n")


class InMemoryExporter:
    """Keeps the last N spans (tests + tracez)."""

    def __init__(self, capacity: int = 512):
        self.spans: deque[Span] = deque(maxlen=capacity)

    def export(self, span: Span) -> None:
        self.spans.append(span)


#: name → factory, mirroring AvailableTraceExporters
_EXPORTERS: dict[str, object] = {
    "log": LogExporter,
    "jsonfile": JsonFileExporter,
    "memory": InMemoryExporter,
}


def register_exporter(name: str, factory) -> None:
    _EXPORTERS[name.lower()] = factory


def available_exporters() -> list[str]:
    return sorted(_EXPORTERS)


def make_exporter(name: str, **kwargs):
    key = name.lower()
    if key == "otlp" and key not in _EXPORTERS:
        # registers itself on import; lazy so the base registry stays dep-free
        import slurm_bridge_tpu_torch.obs.otlp  # noqa: F401
    try:
        factory = _EXPORTERS[key]
    except KeyError:
        raise ValueError(
            f"unknown trace exporter {name!r}; available: {available_exporters()}"
        ) from None
    return factory(**kwargs)


# --------------------------------------------------------------------------
# Tracer
# --------------------------------------------------------------------------

#: the thread whose spans reach the device trace (the tick's thread)
_MAIN_THREAD = threading.main_thread().ident


class _SpanContext:
    """Context manager produced by Tracer.span()."""

    __slots__ = ("_tracer", "_span", "_token", "_range")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self._span = span
        self._token = None
        self._range = None

    def __enter__(self) -> Span:
        # a profiler range of the span's name, opened outside the span's
        # own clock; this module never imports torch, it only looks for it
        prof = sys.modules.get("torch.autograd.profiler")
        if (
            prof is not None
            and getattr(prof, "_is_profiler_enabled", False)
            and threading.get_ident() == _MAIN_THREAD
        ):
            self._range = prof.record_function(self._span.name)
            self._range.__enter__()
        self._span.start = time.time()
        self._span._mono0 = time.perf_counter()
        self._token = _current_span.set(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> None:
        self._span._mono1 = time.perf_counter()
        self._span.end = time.time()
        if exc is not None:
            self._span.status = f"ERROR: {exc_type.__name__}: {exc}"
        _current_span.reset(self._token)
        tracer = self._tracer
        tally = tracer._tally
        if tally is not None and threading.get_ident() == tracer._tally_thread:
            name = self._span.name
            tally[name] = tally.get(name, 0.0) + (
                self._span._mono1 - self._span._mono0
            ) * 1e3
        tracer._finish(self._span)
        if self._range is not None:
            self._range.__exit__(None, None, None)
        return None  # never swallow


def current_span() -> Span | None:
    """The ambient span of this thread/context (tracer-independent)."""
    return _current_span.get()


@contextlib.contextmanager
def with_current_span(span: Span | None):
    """Make ``span`` the ambient parent in THIS thread/context.

    The explicit-parent half of cross-thread propagation: a pool worker
    runs its items under the submitting thread's span so any spans the
    item opens (via the contextvar) parent correctly. No span is created
    and nothing is exported — this only seeds the contextvar.
    """
    token = _current_span.set(span)
    try:
        yield span
    finally:
        _current_span.reset(token)


# --------------------------------------------------------------------------
# W3C-style traceparent propagation — the process-boundary wire format.
# --------------------------------------------------------------------------

#: gRPC metadata key (lowercase per gRPC rules; same spelling the W3C
#: Trace Context spec and every OTel SDK use)
TRACEPARENT_KEY = "traceparent"


def format_traceparent(span: Span) -> str:
    """``00-<32 hex trace>-<16 hex span>-<flags>`` for one span."""
    flags = "01" if span.sampled else "00"
    return f"00-{span.trace_id.zfill(32)}-{span.span_id.zfill(16)}-{flags}"


def current_traceparent() -> str | None:
    """The active span's traceparent header value, or None outside a span."""
    span = _current_span.get()
    return format_traceparent(span) if span is not None else None


def parse_traceparent(value: str) -> Span | None:
    """A remote-parent stub Span from a traceparent header, or None.

    The stub carries trace id / span id / sampled flag only — it is never
    entered or exported; it exists so ``Tracer.span(parent=stub)`` parents
    a server-side span into the caller's trace.
    """
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    _, trace_id, span_id, flags = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16), int(flags, 16)
    except ValueError:
        return None
    return Span(
        name="remote-parent",
        trace_id=trace_id,
        span_id=span_id,
        sampled=bool(int(flags, 16) & 1),
    )


def parent_from_metadata(metadata) -> Span | None:
    """Extract the remote parent from gRPC invocation metadata (a
    sequence of (key, value) pairs), or None when absent/malformed."""
    for key, value in metadata or ():
        if key == TRACEPARENT_KEY:
            return parse_traceparent(value)
    return None


class Tracer:
    """Creates spans; owns the sampling decision and the exporter fan-out.

    Service-level tags are attached to every span (the reserved
    operatingSystem/provider/nodeName tags of tracing.go:33-38,49-51).
    The sampling decision is made at the trace root and inherited by
    children, so a trace is exported whole or not at all.
    """

    def __init__(
        self,
        service: str = "slurm-bridge-tpu",
        *,
        sample: str = "always",
        tags: dict[str, str] | None = None,
    ):
        self.service = service
        self.service_tags = dict(tags or {})
        self._sampler = parse_sampler(sample)
        self._exporters: list = []
        #: immutable snapshot for the _finish hot path: no lock, no
        #: defensive copy per finished span (the flight recorder finishes
        #: dozens of spans inside every tick phase)
        self._exporters_snapshot: tuple = ()
        self._recent = deque(maxlen=256)  # tracez ring, sampled spans only
        self._lock = threading.Lock()
        #: span name → summed ms of one thread's spans (:meth:`tally`)
        self._tally: dict[str, float] | None = None
        self._tally_thread: int | None = None

    # -- configuration ----------------------------------------------------
    def configure(
        self,
        *,
        sample: str | None = None,
        service: str | None = None,
        tags: dict[str, str] | None = None,
    ) -> "Tracer":
        if sample is not None:
            self._sampler = parse_sampler(sample)
        if service is not None:
            self.service = service
        if tags:
            self.service_tags.update(tags)
        return self

    def add_exporter(self, exporter) -> "Tracer":
        with self._lock:
            self._exporters.append(exporter)
            self._exporters_snapshot = tuple(self._exporters)
        return self

    def remove_exporter(self, exporter) -> None:
        with self._lock:
            self._exporters = [e for e in self._exporters if e is not exporter]
            self._exporters_snapshot = tuple(self._exporters)

    def clear_exporters(self) -> None:
        with self._lock:
            self._exporters.clear()
            self._exporters_snapshot = ()

    @contextlib.contextmanager
    def recording(self, sink):
        """Temporarily force sampling on and fan spans out to ``sink``
        (an exporter) — the flight recorder's per-tick capture window.
        Restores the previous sampler and removes the sink on exit."""
        with self._lock:
            prev_sampler = self._sampler
            self._sampler = lambda: True
            self._exporters.append(sink)
            self._exporters_snapshot = tuple(self._exporters)
        try:
            yield sink
        finally:
            with self._lock:
                self._sampler = prev_sampler
                self._exporters = [e for e in self._exporters if e is not sink]
                self._exporters_snapshot = tuple(self._exporters)

    @contextlib.contextmanager
    def tally(self):
        """Tally the calling thread's spans for the ``with`` block: every
        span that closes on it adds its milliseconds under its name,
        sampled or not. Yields the tally's dict, which stays readable
        after the block; spans closed after it add nothing."""
        tally: dict[str, float] = {}
        self._tally, self._tally_thread = tally, threading.get_ident()
        try:
            yield tally
        finally:
            self._tally = self._tally_thread = None

    # -- span creation ----------------------------------------------------
    def span(
        self, name: str, *, parent: Span | None = None, **tags
    ) -> _SpanContext:
        if parent is None:
            parent = _current_span.get()
        if parent is not None:
            trace_id, parent_id, sampled = parent.trace_id, parent.span_id, parent.sampled
        else:
            trace_id, parent_id, sampled = _new_id(16), None, self._sampler()
        if self.service_tags:
            merged = dict(self.service_tags)
            for k, v in tags.items():
                merged[k] = str(v)
        elif tags:
            merged = {k: str(v) for k, v in tags.items()}
        else:
            merged = {}
        span = Span(
            name=name,
            trace_id=trace_id,
            span_id=_new_id(8),
            parent_id=parent_id,
            tags=merged,
            sampled=sampled,
            parent=parent,
        )
        return _SpanContext(self, span)

    def current(self) -> Span | None:
        return _current_span.get()

    def emit_synthetic(
        self,
        name: str,
        *,
        parent: Span,
        duration_s: float,
        start_offset_s: float = 0.0,
        tags: dict | None = None,
        counters: dict | None = None,
    ) -> Span:
        """Materialize an already-finished child span under ``parent``.

        The cross-process stitching primitive (ISSUE 20): a remote or
        forked worker reports measured phase durations after the fact
        (PlaceShardResponse timing ns, colpool reply timing headers) and
        the parent turns them into child spans, so flight-record
        attribution crosses fork() and gRPC. Exported immediately — call
        while ``parent`` is still OPEN so the recorder's child-sum
        bookkeeping (parent self-time = wall − children) accounts for it.
        """
        span = Span(
            name=name,
            trace_id=parent.trace_id,
            span_id=_new_id(8),
            parent_id=parent.span_id,
            tags={k: str(v) for k, v in (tags or {}).items()},
            counters=dict(counters or {}),
            sampled=parent.sampled,
            parent=parent,
        )
        span.start = (parent.start or time.time()) + start_offset_s
        span.end = span.start + duration_s
        if parent._mono0:
            span._mono0 = parent._mono0 + start_offset_s
            span._mono1 = span._mono0 + duration_s
        self._finish(span)
        return span

    def _finish(self, span: Span) -> None:
        if not span.sampled:
            return
        # deque.append is atomic under the GIL; the exporter snapshot is
        # immutable — no lock on the per-span finish path
        self._recent.append(span)
        for e in self._exporters_snapshot:
            try:
                e.export(span)
            except Exception:
                log.exception("trace exporter %r failed", e)

    # -- tracez -----------------------------------------------------------
    def render_tracez(self) -> str:
        """Plain-text zpages-style summary: per-span-name latency stats plus
        the most recent spans (tracing.go:94-114's debug server)."""
        with self._lock:
            recent = list(self._recent)
        by_name: dict[str, list[Span]] = {}
        for s in recent:
            by_name.setdefault(s.name, []).append(s)
        lines = [f"tracez — service={self.service} spans={len(recent)}", ""]
        lines.append(f"{'span':40s} {'count':>6s} {'avg_ms':>9s} {'max_ms':>9s} {'errors':>6s}")
        for name in sorted(by_name):
            spans = by_name[name]
            durs = [s.duration * 1e3 for s in spans]
            errs = sum(1 for s in spans if s.status != "OK")
            lines.append(
                f"{name:40s} {len(spans):6d} {sum(durs)/len(durs):9.2f} "
                f"{max(durs):9.2f} {errs:6d}"
            )
        lines.append("")
        lines.append("recent spans:")
        for s in recent[-25:]:
            lines.append(
                f"  {s.name:38s} trace={s.trace_id[:8]} {s.duration*1e3:8.2f}ms "
                f"{s.status}"
            )
        lines.extend(self._render_recent_ticks(recent))
        return "\n".join(lines) + "\n"

    @staticmethod
    def _render_recent_ticks(recent: list[Span], limit: int = 3) -> list[str]:
        """The per-tick view: the newest root ``*.tick`` spans rendered as
        indented trees (children by parent id, insertion order), with
        durations and counters — a flight-record glance without pulling
        the JSON artifact."""
        roots = [
            s for s in recent if s.parent_id is None and s.name.endswith(".tick")
        ][-limit:]
        if not roots:
            return []
        by_parent: dict[str, list[Span]] = {}
        for s in recent:
            if s.parent_id:
                by_parent.setdefault((s.trace_id, s.parent_id), []).append(s)
        lines = ["", "recent ticks:"]
        for root in roots:
            header = f"tick trace={root.trace_id[:8]}"
            tick_no = root.tags.get("tick")
            if tick_no is not None:
                header += f" tick={tick_no}"
            lines.append(header)
            stack = [(root, 1)]
            budget = 40  # a storm of rpc spans must not flood the page
            while stack and budget:
                span, depth = stack.pop()
                budget -= 1
                counters = " ".join(
                    f"{k}={v:g}" for k, v in sorted(span.counters.items())
                )
                lines.append(
                    f"{'  ' * depth}{span.name:{max(1, 40 - 2 * depth)}s} "
                    f"{span.duration * 1e3:9.2f}ms"
                    + (f"  {counters}" if counters else "")
                )
                children = by_parent.get((span.trace_id, span.span_id), [])
                for child in reversed(children):
                    stack.append((child, depth + 1))
        return lines


#: process-wide default tracer (never-sampled until configured, so unwired
#: code paths pay only a contextvar read)
TRACER = Tracer(sample="never")


def setup_tracing(
    service: str,
    *,
    sample: str | None = None,
    exporter: str | None = None,
    node_name: str = "",
    **exporter_kwargs,
) -> Tracer:
    """One-call configuration mirroring vk.Run's SetupTracing
    (virtual-kubelet.go:244): reads ``SBT_TRACE_SAMPLE`` / ``SBT_TRACE_EXPORTER``
    env defaults the way the Jaeger exporter is env-driven in the reference.
    """
    sample = sample if sample is not None else os.environ.get("SBT_TRACE_SAMPLE", "never")
    exporter = exporter if exporter is not None else os.environ.get("SBT_TRACE_EXPORTER", "")
    tags = {"service": service, "operatingSystem": "Linux", "provider": "slurm-bridge-tpu"}
    if node_name:
        tags["nodeName"] = node_name
    TRACER.configure(sample=sample, service=service, tags=tags)
    if exporter:
        TRACER.add_exporter(make_exporter(exporter, **exporter_kwargs))
    return TRACER


# --------------------------------------------------------------------------
# gRPC server interceptor — one span per RPC, the process-boundary hook the
# reference gets from the virtual-kubelet library's span wrappers. Incoming
# ``traceparent`` metadata (injected by the ServiceClient) parents the RPC
# span into the caller's trace, so an agent-side SubmitJobs span hangs off
# the bridge's scheduler tick instead of starting a trace of its own.
# --------------------------------------------------------------------------

def tracing_interceptor(tracer: Tracer | None = None):
    import grpc

    tracer = tracer or TRACER

    class _Interceptor(grpc.ServerInterceptor):
        def intercept_service(self, continuation, handler_call_details):
            handler = continuation(handler_call_details)
            if handler is None:
                return None
            method = handler_call_details.method.rsplit("/", 1)[-1]
            parent = parent_from_metadata(
                getattr(handler_call_details, "invocation_metadata", ())
            )

            def wrap_unary(behavior):
                def inner(request, context):
                    with tracer.span(f"rpc.{method}", parent=parent):
                        return behavior(request, context)
                return inner

            def wrap_stream(behavior):
                def inner(request_or_iter, context):
                    with tracer.span(f"rpc.{method}", parent=parent) as span:
                        n = 0
                        for item in behavior(request_or_iter, context):
                            n += 1
                            yield item
                        span.set_tag("messages", n)
                return inner

            kind_attrs = (
                ("unary_unary", grpc.unary_unary_rpc_method_handler, wrap_unary),
                ("unary_stream", grpc.unary_stream_rpc_method_handler, wrap_stream),
                ("stream_unary", grpc.stream_unary_rpc_method_handler, wrap_unary),
                ("stream_stream", grpc.stream_stream_rpc_method_handler, wrap_stream),
            )
            for attr, maker, wrapper in kind_attrs:
                behavior = getattr(handler, attr)
                if behavior is not None:
                    return maker(
                        wrapper(behavior),
                        request_deserializer=handler.request_deserializer,
                        response_serializer=handler.response_serializer,
                    )
            return handler

    return _Interceptor()
