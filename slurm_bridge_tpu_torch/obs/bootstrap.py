"""Shared daemon observability bootstrap — flags + one-call startup.

Every daemon (agent main, bridge main) gets the same observability surface
the reference spreads across its binaries: a metrics server with
healthz/readyz probes (bridge-operator.go:57,100-107), tracing with
env-overridable sampling (SURVEY.md §5), and the /debug/tracez zpages view.
One helper holds the one correct version so the daemons cannot diverge.
"""

from __future__ import annotations

import logging

from slurm_bridge_tpu_torch.obs.metrics import REGISTRY
from slurm_bridge_tpu_torch.obs.tracing import TRACER, setup_tracing

log = logging.getLogger("sbt.obs")


def add_observability_flags(parser, *, metrics_port_default: int = 0) -> None:
    parser.add_argument(
        "--metrics-port", type=int, default=metrics_port_default,
        help="metrics/healthz/readyz/tracez port; 0 disables",
    )
    parser.add_argument(
        "--trace-sample", default=None,
        help="always|never|0-100 (default: $SBT_TRACE_SAMPLE or never)",
    )
    parser.add_argument(
        "--trace-exporter", default=None,
        help="log|jsonfile|memory (default: $SBT_TRACE_EXPORTER or none)",
    )


def start_observability(
    service: str,
    args,
    *,
    health_checks: dict | None = None,
    ready_checks: dict | None = None,
    node_name: str = "",
):
    """Configure tracing from flags/env and start the metrics server.

    Returns the HTTP server (caller shuts it down) or None when disabled.
    Flags left at None fall through to the SBT_TRACE_* env vars inside
    :func:`setup_tracing`; an explicitly empty value means "off"
    (sample "" → never, exporter "" → none), overriding the env.
    """
    setup_tracing(
        service,
        sample="never" if args.trace_sample == "" else args.trace_sample,
        exporter="" if args.trace_exporter == "" else (args.trace_exporter or None),
        node_name=node_name,
    )
    if not getattr(args, "metrics_port", 0):
        return None
    from slurm_bridge_tpu_torch.fleet.runtime import render_fleetz
    from slurm_bridge_tpu_torch.obs.explain import SCHEDZ
    from slurm_bridge_tpu_torch.obs.profiling import sample_profile

    httpd = REGISTRY.serve(
        args.metrics_port,
        extra_routes={
            "/debug/tracez": lambda: ("text/plain", TRACER.render_tracez()),
            # py-spy-style stack sampling (obs/profiling.py) — the
            # reference's net/http/pprof side-effect import, rebuilt
            "/debug/profilez": lambda: ("text/plain", sample_profile()),
            # placement pressure (ISSUE 15): the live reason-code
            # ledger every PlacementScheduler publishes per solve tick
            "/debug/schedz": lambda: ("text/plain", SCHEDZ.render()),
            # fleet membership/ownership/sidecar health (ISSUE 17):
            # every live FleetRuntime in the process renders here
            "/debug/fleetz": lambda: ("text/plain", render_fleetz()),
        },
        health_checks=health_checks or {"ping": lambda: None},
        ready_checks=ready_checks or {},
    )
    log.info("%s: metrics/healthz/tracez/profilez/schedz/fleetz on :%d",
             service, args.metrics_port)
    return httpd
