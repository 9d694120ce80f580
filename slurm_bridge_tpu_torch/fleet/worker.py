"""Solver sidecar entrypoint: ``python -m slurm_bridge_tpu_torch.fleet.worker``.

A deliberately thin PlacementSolver servicer: PlaceShard runs the pure
columnar solve (``columnar.solve_place_shard``), Healthz answers the
supervisor's version handshake. The full ``solver/service.py`` servicer
(device sessions, XLA bucketing) stays for Place; this process exists to
be spawned per bridge replica, killed by chaos, and restarted cheaply.

Fleet observability (ISSUE 20): the sidecar runs its own tracer — the
``tracing_interceptor`` opens an ``rpc.PlaceShard`` server span parented
into the bridge's trace via the W3C ``traceparent`` metadata the
ServiceClient injects, so OTLP exports from both processes stitch into
one trace (resource identity ``sbt-sidecar-<replica>`` + pid +
incarnation). Logging adopts the ``obs/logging.py`` KV/JSON formatters,
so sidecar log lines carry trace_id/span_id from the active PlaceShard
span. Healthz additionally returns this process's counter totals; the
bridge's per-tick heartbeat federates them under a ``replica`` label.

Protocol with the supervisor (test_failover_process.py pattern): after
the server binds, print ONE JSON line ``{"ready": true, "pid": ...,
"endpoint": ...}`` on stdout and flush — a crashed worker closes stdout,
so the supervisor's readline returns "" instead of hanging.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

from slurm_bridge_tpu_torch.fleet.columnar import healthz_response, solve_place_shard
from slurm_bridge_tpu_torch.obs.metrics import REGISTRY
from slurm_bridge_tpu_torch.wire import messages as pb

_place_shards = REGISTRY.counter(
    "sbt_sidecar_place_shards_total",
    "PlaceShard solves served by this sidecar",
)
_phase_seconds = REGISTRY.counter(
    "sbt_sidecar_phase_seconds_total",
    "sidecar-side PlaceShard time by phase (decode|solve|encode)",
)
_rows_total = REGISTRY.counter(
    "sbt_sidecar_rows_total",
    "placement rows solved by this sidecar",
)


class SidecarServicer:
    """PlaceShard + Healthz; everything else degrades to UNIMPLEMENTED."""

    def __init__(self, incarnation: str, shard_set: tuple[int, ...] = ()):
        self.incarnation = incarnation
        self.shard_set = tuple(shard_set)

    def PlaceShard(self, request: pb.PlaceShardRequest, context) -> pb.PlaceShardResponse:
        resp = solve_place_shard(request)
        _place_shards.inc()
        _rows_total.inc(float(resp.rows))
        _phase_seconds.inc(resp.decode_ns / 1e9, phase="decode")
        _phase_seconds.inc(resp.solve_ns / 1e9, phase="solve")
        _phase_seconds.inc(resp.encode_ns / 1e9, phase="encode")
        return resp

    def Healthz(self, request: pb.HealthzRequest, context) -> pb.HealthzResponse:
        return healthz_response(
            "solver",
            self.incarnation,
            self.shard_set,
            metrics=REGISTRY.counter_totals(),
        )


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="slurm_bridge_tpu_torch.fleet.worker",
        description="solver sidecar: PlaceShard + Healthz over gRPC",
    )
    parser.add_argument("--listen", required=True,
                        help="endpoint to bind (host:port or /path.sock)")
    parser.add_argument("--replica-id", default="replica-0",
                        help="owning bridge replica (labels only)")
    parser.add_argument("--incarnation", default="0",
                        help="spawn-unique id echoed by Healthz")
    parser.add_argument("--shards", default="",
                        help="comma-separated shard ids this sidecar serves")
    args = parser.parse_args(argv)

    from slurm_bridge_tpu_torch.obs.logging import setup_logging
    from slurm_bridge_tpu_torch.obs.tracing import setup_tracing, tracing_interceptor
    from slurm_bridge_tpu_torch.wire.rpc import serve

    # log↔trace correlation: the KV/JSON formatters append trace_id/span_id
    # from the active PlaceShard span; stderr is relayed (replica-prefixed)
    # by the supervisor
    setup_logging(json_lines=bool(os.environ.get("SBT_LOG_JSON")))

    # own tracer identity per process role: stitched traces group as
    # sbt-sidecar-<replica> in Jaeger/Tempo while the bridge keeps its
    # existing service name; OTLP resource attrs carry pid + incarnation
    service = f"sbt-sidecar-{args.replica_id}"
    exporter_kwargs = {}
    if os.environ.get("SBT_TRACE_EXPORTER", "") == "otlp":
        exporter_kwargs["resource_attrs"] = {
            "process.pid": os.getpid(),
            "sbt.replica": args.replica_id,
            "sbt.incarnation": args.incarnation,
        }
    setup_tracing(service, node_name=args.replica_id, **exporter_kwargs)

    shard_set = tuple(
        int(s) for s in args.shards.split(",") if s.strip()
    )
    servicer = SidecarServicer(args.incarnation, shard_set)
    server = serve(
        {"PlacementSolver": servicer},
        args.listen,
        max_workers=4,
        interceptors=(tracing_interceptor(),),
    )

    print(json.dumps({
        "ready": True,
        "pid": os.getpid(),
        "endpoint": args.listen,
        "incarnation": args.incarnation,
    }), flush=True)

    stop = threading.Event()

    def _stop(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, _stop)
    signal.signal(signal.SIGINT, _stop)
    stop.wait()
    server.stop(grace=0.5)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
