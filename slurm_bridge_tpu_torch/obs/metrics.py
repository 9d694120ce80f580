"""Minimal Prometheus-exposition metrics.

Reference parity: the controller-runtime metrics servers on :8080 and the
declared-but-dead VK stats endpoints (SURVEY.md §5). Here one registry
serves every daemon, exposed in Prometheus text format over a tiny
stdlib HTTP server — no client_golang equivalent needed.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


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
        """Current value for one label set — for tests and in-process
        consumers, without parsing the exposition text."""
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def total(self) -> float:
        """Sum over every label set — the flight recorder's counter-delta
        reads, without enumerating label combinations."""
        with self._lock:
            return sum(self._values.values())

    def reset(self) -> None:
        with self._lock:
            self._values.clear()

    def collect(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            for key, val in self._values.items():
                out.append(f"{self.name}{_fmt_labels(dict(key))} {val}")
        return out


class Gauge:
    def __init__(self, name: str, help_: str = ""):
        self.name, self.help = name, help_
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[tuple(sorted(labels.items()))] = value

    def handle(self, **labels: str):
        """A bound setter with the label key resolved ONCE — for hot-path
        callers (the work-queue depth updates on every add/pop) that would
        otherwise rebuild the sorted label tuple per observation."""
        key = tuple(sorted(labels.items()))

        def set_value(value: float) -> None:
            with self._lock:
                self._values[key] = value

        return set_value

    def reset(self) -> None:
        with self._lock:
            self._values.clear()

    def collect(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            for key, val in self._values.items():
                out.append(f"{self.name}{_fmt_labels(dict(key))} {val}")
        return out


class Histogram:
    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.2, 0.5, 1.0, 5.0, 30.0)
    #: For sub-millisecond phases (e.g. the cached encode path): the default
    #: buckets would dump every observation into the first bucket, hiding
    #: any regression below 1 ms.
    FAST_BUCKETS = (
        0.00001, 0.00005, 0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1,
        0.5, 1.0,
    )

    def __init__(self, name: str, help_: str = "", buckets=DEFAULT_BUCKETS):
        self.name, self.help = name, help_
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._total = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._total += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._total = 0

    def quantile(self, q: float) -> float:
        """Approximate quantile from bucket counts (upper bound)."""
        with self._lock:
            if not self._total:
                return 0.0
            target = q * self._total
            acc = 0
            for i, b in enumerate(self.buckets):
                acc += self._counts[i]
                if acc >= target:
                    return b
            return float("inf")

    def collect(self) -> list[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            acc = 0
            for i, b in enumerate(self.buckets):
                acc += self._counts[i]
                out.append(f'{self.name}_bucket{{le="{b}"}} {acc}')
            acc += self._counts[-1]
            out.append(f'{self.name}_bucket{{le="+Inf"}} {acc}')
            out.append(f"{self.name}_sum {self._sum}")
            out.append(f"{self.name}_count {self._total}")
        return out


class MetricsRegistry:
    def __init__(self):
        self._metrics: list = []
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._register(Counter(name, help_))

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._register(Gauge(name, help_))

    def histogram(self, name: str, help_: str = "", **kw) -> Histogram:
        return self._register(Histogram(name, help_, **kw))

    def _register(self, metric):
        with self._lock:
            self._metrics.append(metric)
        return metric

    def register(self, collector):
        """Register a custom collector: any object with a ``collect() ->
        list[str]`` of exposition lines (and optionally a ``name``). Used
        by metrics whose source of truth lives elsewhere — the store's
        commit counters are plain dicts incremented under the store lock,
        and the collector reads them only at scrape time."""
        return self._register(collector)

    def reset_values(self) -> None:
        """Zero every metric's observed values, keeping registrations.

        Fork hygiene (ISSUE 20): a forked colpool worker inherits the
        parent's registry by COW — calling this first thing post-fork
        means a future worker-side scrape can never double-count parent
        totals. Custom collectors (no ``reset`` attr) are skipped: their
        source of truth lives elsewhere.
        """
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            reset = getattr(m, "reset", None)
            if callable(reset):
                reset()

    def counter_totals(self) -> dict[str, float]:
        """``{name: summed value}`` for every Counter — the flight
        recorder snapshots this per tick and reports the deltas."""
        with self._lock:
            metrics = list(self._metrics)
        return {m.name: m.total() for m in metrics if isinstance(m, Counter)}

    def render(self) -> str:
        lines: list[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            lines.extend(m.collect())
        return "\n".join(lines) + "\n"

    def serve(
        self,
        port: int,
        host: str = "0.0.0.0",
        *,
        extra_routes: dict | None = None,
        health_checks: dict | None = None,
        ready_checks: dict | None = None,
    ) -> ThreadingHTTPServer:
        """Start /metrics + /healthz + /readyz on a background thread.

        ``extra_routes`` maps a path prefix to ``() -> (content_type, body)``
        — used for the /debug/tracez zpages view (SURVEY.md §5 tracing).
        ``health_checks`` / ``ready_checks`` map name → ``() -> None`` checks
        that raise on failure, reproducing the operator's named healthz/readyz
        checkers (bridge-operator.go:100-107); a failing check turns the
        probe into a 500 listing the failures.
        """
        registry = self
        extra = dict(extra_routes or {})

        def run_checks(checks: dict) -> tuple[int, bytes]:
            failures = []
            for name, check in checks.items():
                try:
                    check()
                except Exception as exc:  # a probe must never crash the server
                    failures.append(f"{name}: {exc}")
            if failures:
                return 500, ("\n".join(failures) + "\n").encode()
            return 200, b"ok"

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                status = 200
                if self.path.startswith("/healthz"):
                    status, body = run_checks(health_checks or {})
                    ctype = "text/plain"
                elif self.path.startswith("/readyz"):
                    status, body = run_checks(ready_checks or {})
                    ctype = "text/plain"
                elif self.path.startswith("/metrics"):
                    body = registry.render().encode()
                    ctype = "text/plain; version=0.0.4"
                elif any(self.path.startswith(p) for p in extra):
                    prefix = next(p for p in extra if self.path.startswith(p))
                    try:
                        ctype, text = extra[prefix]()
                        body = text.encode() if isinstance(text, str) else text
                    except Exception as exc:  # a debug page must never drop the conn
                        status, ctype = 500, "text/plain"
                        body = f"handler for {prefix} failed: {exc}\n".encode()
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        httpd = ThreadingHTTPServer((host, port), Handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd


#: process-wide default registry
REGISTRY = MetricsRegistry()
