"""sbt-agent — the login-node daemon.

Reference parity: cmd/slurm-agent/slurm-agent.go — serves the
WorkloadManager on both a unix socket and a TCP port, loads the YAML
partition config, handles signals.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import threading

from slurm_bridge_tpu_torch.agent.cli import SlurmClient
from slurm_bridge_tpu_torch.agent.config import load_partition_config
from slurm_bridge_tpu_torch.agent.server import WorkloadServicer
from slurm_bridge_tpu_torch.obs.bootstrap import add_observability_flags, start_observability
from slurm_bridge_tpu_torch.obs.logging import setup_logging
from slurm_bridge_tpu_torch.obs.tracing import tracing_interceptor
from slurm_bridge_tpu_torch.wire import serve

DEFAULT_SOCKET = "/var/run/sbt/agent.sock"
DEFAULT_LISTEN = "0.0.0.0:9999"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="slurm-bridge-tpu agent")
    parser.add_argument("--listen", default=DEFAULT_LISTEN, help="TCP host:port")
    parser.add_argument("--socket", default="", help="unix socket path (optional)")
    parser.add_argument("--config", default="", help="partition overrides YAML")
    parser.add_argument("--ledger", default="", help="submit-dedupe state file")
    parser.add_argument(
        "--journal", default="",
        help="agent job-state journal path (WAL-backed submit ledger + "
        "in-flight job index; supersedes --ledger when set)",
    )
    add_observability_flags(parser)
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)

    setup_logging(verbose=args.verbose)
    log = logging.getLogger("sbt.agent")

    partition_config = load_partition_config(args.config) if args.config else {}
    servicer = WorkloadServicer(
        SlurmClient(),
        partition_config=partition_config,
        ledger_file=args.ledger or None,
        journal_file=args.journal or None,
        # the wire agent serves JobsInfo as pre-assembled bytes (ISSUE
        # 14): byte-compatible on the wire, skips the response-message
        # copy+re-serialization per poll
        serve_bytes=True,
    )

    interceptors = (tracing_interceptor(),)
    servers = [serve({"WorkloadManager": servicer}, args.listen,
                     interceptors=interceptors)]
    log.info("serving WorkloadManager on %s", args.listen)
    if args.socket:
        servers.append(serve({"WorkloadManager": servicer}, args.socket,
                             interceptors=interceptors))
        log.info("serving WorkloadManager on %s", args.socket)

    httpd = start_observability(
        "sbt-agent", args,
        ready_checks={"slurm": lambda: servicer.driver.version()},
    )

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    log.info("shutting down")
    for s in servers:
        s.stop(grace=5).wait()
    if httpd is not None:
        httpd.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
