"""OTLP/HTTP trace exporter — spans leave the process in a wire format.

Reference parity: the VK's Jaeger exporter
(cmd/slurm-virtual-kubelet/app/options/tracing_register_jaeger.go:29-52,
env-driven endpoint) and OC-agent exporter (tracing_register_ocagent.go).
The rebuild speaks today's lingua franca instead: OTLP/HTTP with JSON
encoding (``POST <endpoint>/v1/traces``), which Jaeger ≥1.35, Grafana
Tempo, and every OpenTelemetry collector ingest natively. Stdlib-only
(urllib), batched with a background flusher so ``export()`` never blocks
a traced code path, bounded queue with drop counting so a dead collector
cannot wedge the process.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import urllib.error
import urllib.request
from collections import deque

from slurm_bridge_tpu_torch.obs.metrics import REGISTRY
from slurm_bridge_tpu_torch.obs.tracing import Span, register_exporter

log = logging.getLogger("sbt.otlp")

#: exporter health on /metrics — a dead collector is a warning log today
#: and silence tomorrow; these make it a visible, alertable signal
_exported_total = REGISTRY.counter(
    "sbt_otlp_exported_spans_total", "spans delivered to the OTLP collector"
)
_dropped_total = REGISTRY.counter(
    "sbt_otlp_dropped_spans_total",
    "spans dropped (queue overflow or failed POST to the collector)",
)
_queue_depth = REGISTRY.gauge(
    "sbt_otlp_queue_depth", "spans waiting in the OTLP export queue"
)

#: standard OTel env var, same spelling the collector ecosystem uses
ENDPOINT_ENV = "OTEL_EXPORTER_OTLP_ENDPOINT"
DEFAULT_ENDPOINT = "http://localhost:4318"


def _attr(key: str, value: str) -> dict:
    return {"key": key, "value": {"stringValue": str(value)}}


def span_to_otlp(span: Span) -> dict:
    """One Span → an OTLP JSON span object (trace/v1 schema).

    Ids are zero-padded to OTLP's fixed widths (16-byte trace, 8-byte
    span); a span with no parent omits parentSpanId entirely.
    """
    out = {
        "traceId": span.trace_id.zfill(32),
        "spanId": span.span_id.zfill(16),
        "name": span.name,
        "kind": 1,  # SPAN_KIND_INTERNAL
        "startTimeUnixNano": str(int(span.start * 1e9)),
        "endTimeUnixNano": str(int((span.end or span.start) * 1e9)),
        "attributes": [_attr(k, v) for k, v in span.tags.items()],
        "events": [
            {"timeUnixNano": str(int(t * 1e9)), "name": msg}
            for t, msg in span.annotations
        ],
        "status": (
            {"code": 1}
            if span.status == "OK"
            else {"code": 2, "message": span.status}
        ),
    }
    if span.parent_id:
        out["parentSpanId"] = span.parent_id.zfill(16)
    return out


def encode_batch(
    spans: list[Span], service: str, resource_attrs: dict | None = None
) -> bytes:
    """OTLP/HTTP JSON request body for one batch.

    ``resource_attrs`` extends the resource identity beyond
    ``service.name`` — the sidecar sets process role attributes
    (``process.pid``, ``sbt.replica``, ``sbt.incarnation``) so stitched
    traces group per process in Jaeger/Tempo (ISSUE 20).
    """
    attrs = [_attr("service.name", service)]
    for key in sorted(resource_attrs or {}):
        attrs.append(_attr(key, resource_attrs[key]))
    return json.dumps(
        {
            "resourceSpans": [
                {
                    "resource": {"attributes": attrs},
                    "scopeSpans": [
                        {
                            "scope": {"name": "slurm-bridge-tpu"},
                            "spans": [span_to_otlp(s) for s in spans],
                        }
                    ],
                }
            ]
        },
        separators=(",", ":"),
    ).encode()


class OtlpHttpExporter:
    """Batched OTLP/HTTP JSON exporter.

    ``export()`` enqueues and returns; a daemon thread flushes every
    ``flush_interval`` seconds or as soon as ``batch_size`` spans are
    pending. The queue is bounded: when the collector is down, old spans
    are dropped (counted in ``dropped``) rather than growing without
    bound or blocking the traced path.
    """

    def __init__(
        self,
        endpoint: str | None = None,
        *,
        service: str = "slurm-bridge-tpu",
        batch_size: int = 64,
        flush_interval: float = 2.0,
        queue_limit: int = 4096,
        timeout: float = 5.0,
        resource_attrs: dict | None = None,
    ):
        base = (endpoint or os.environ.get(ENDPOINT_ENV) or DEFAULT_ENDPOINT)
        self.url = base.rstrip("/") + "/v1/traces"
        self.service = service
        self.resource_attrs = dict(resource_attrs or {})
        self.batch_size = batch_size
        self.flush_interval = flush_interval
        self.timeout = timeout
        self.dropped = 0
        self.sent = 0
        self._queue: deque[Span] = deque(maxlen=queue_limit)
        self._cv = threading.Condition()
        self._closed = False
        self._thread = threading.Thread(
            target=self._run, name="otlp-exporter", daemon=True
        )
        self._thread.start()

    # -- exporter interface -------------------------------------------------
    def export(self, span: Span) -> None:
        with self._cv:
            if len(self._queue) == self._queue.maxlen:
                self.dropped += 1
                _dropped_total.inc()
            self._queue.append(span)
            _queue_depth.set(len(self._queue))
            if len(self._queue) >= self.batch_size:
                self._cv.notify()

    def flush(self) -> None:
        """Synchronously drain the queue (tests / shutdown)."""
        self._send(self._take_all())

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._thread.join(self.timeout + 1.0)
        self.flush()

    # -- internals ----------------------------------------------------------
    def _take_all(self) -> list[Span]:
        with self._cv:
            batch = list(self._queue)
            self._queue.clear()
            _queue_depth.set(0)
        return batch

    def _run(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    return
                self._cv.wait(self.flush_interval)
                if self._closed:
                    return
            self._send(self._take_all())

    def _send(self, batch: list[Span]) -> None:
        if not batch:
            return
        body = encode_batch(batch, self.service, self.resource_attrs)
        req = urllib.request.Request(
            self.url, data=body, headers={"Content-Type": "application/json"}
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                resp.read()
            self.sent += len(batch)
            _exported_total.inc(len(batch))
        except (urllib.error.URLError, OSError) as e:
            self.dropped += len(batch)
            _dropped_total.inc(len(batch))
            log.warning(
                "OTLP export of %d spans to %s failed: %s",
                len(batch), self.url, e,
            )


register_exporter("otlp", OtlpHttpExporter)
