"""Structured logging setup shared by every daemon.

The reference mixes four logging stacks (logrus/klog/zap/vk-adapter —
SURVEY.md §5 "Metrics/logging"); here one configuration serves all
binaries: key=value text for humans, or JSON lines with ``json_lines=True``
for collectors.

Log↔trace correlation (ISSUE 15 satellite): when a line is emitted
inside a SAMPLED span, both formatters append the active span's
``trace_id``/``span_id`` (read from the tracing contextvar — zero setup,
zero cost outside a span), so JSON log lines join against flight records
and OTLP traces instead of standing alone with ts/level/logger/msg.
Unsampled spans stay silent: a never-sampled production path logs
exactly the pre-ISSUE-15 bytes.
"""

from __future__ import annotations

import json
import logging
import sys
import time

from slurm_bridge_tpu_torch.obs.tracing import current_span


class KVFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(record.created))
        base = f"{ts} {record.levelname:<7} {record.name} {record.getMessage()}"
        span = current_span()
        if span is not None and span.sampled:
            base += f" trace={span.trace_id} span={span.span_id}"
        if record.exc_info:
            base += "\n" + self.formatException(record.exc_info)
        return base


class JSONFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload = {
            "ts": record.created,
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        span = current_span()
        if span is not None and span.sampled:
            payload["trace_id"] = span.trace_id
            payload["span_id"] = span.span_id
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload)


def setup_logging(*, verbose: bool = False, json_lines: bool = False) -> None:
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(JSONFormatter() if json_lines else KVFormatter())
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(logging.DEBUG if verbose else logging.INFO)
