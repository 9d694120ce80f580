"""Observability: structured logging, metrics registry, event recorder,
distributed tracing (spans / samplers / exporters / tracez)."""

from slurm_bridge_tpu_torch.obs.logging import setup_logging
from slurm_bridge_tpu_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry, REGISTRY
from slurm_bridge_tpu_torch.obs.events import Event, EventRecorder, Reason
from slurm_bridge_tpu_torch.obs.tracing import (
    TRACER,
    InMemoryExporter,
    JsonFileExporter,
    LogExporter,
    Span,
    Tracer,
    setup_tracing,
    tracing_interceptor,
)
from slurm_bridge_tpu_torch.obs.otlp import OtlpHttpExporter

__all__ = [
    "setup_logging",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "Event",
    "EventRecorder",
    "Reason",
    "TRACER",
    "Tracer",
    "Span",
    "LogExporter",
    "JsonFileExporter",
    "InMemoryExporter",
    "OtlpHttpExporter",
    "setup_tracing",
    "tracing_interceptor",
]
