"""Minimal Prometheus-exposition counters for the solver's lowering layer.

The slice of the JAX package's ``obs/metrics.py`` that the encoders use:
a process-wide :data:`REGISTRY` handing out labelled :class:`Counter`\\ s,
rendered in Prometheus text format.
"""

from __future__ import annotations

import threading
from collections import defaultdict


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._values: dict[tuple, float] = defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        with self._lock:
            self._values[tuple(sorted(labels.items()))] += amount

    def value(self, **labels: str) -> float:
        """Current value for one label set."""
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def collect(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            for key, val in self._values.items():
                out.append(f"{self.name}{_fmt_labels(dict(key))} {val}")
        return out


class MetricsRegistry:
    def __init__(self):
        self._metrics: list[Counter] = []
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        metric = Counter(name, help_)
        with self._lock:
            self._metrics.append(metric)
        return metric

    def render(self) -> str:
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"


#: process-wide default registry
REGISTRY = MetricsRegistry()
