"""sbt-bridge — the control-plane daemon.

Reference parity: cmd/bridge-operator/bridge-operator.go (manager main:
leader election :59-61, metrics server :57,73, healthz/readyz probes
:100-107, reconciler thread flag :62) plus the configurator daemon main
(cmd/configurator/configurator.go:53-114) — the rebuild runs the operator,
configurator, scheduler, and fetch worker in one process (SURVEY.md §7),
so one main serves them all.

    python -m slurm_bridge_tpu_torch.bridge.main --endpoint host:9999 \
        [--scheduler auto|auction|greedy] [--metrics-port 8080] \
        [--leader-lock /var/run/sbt/bridge.lease] [--threads N]
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading

from slurm_bridge_tpu_torch.bridge.leader import LeaderElector
from slurm_bridge_tpu_torch.bridge.runtime import Bridge
from slurm_bridge_tpu_torch.obs.bootstrap import add_observability_flags, start_observability
from slurm_bridge_tpu_torch.obs.logging import setup_logging
from slurm_bridge_tpu_torch.utils.codec import explicit_flags


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="slurm-bridge-tpu control plane")
    parser.add_argument("--endpoint", required=True, help="agent endpoint (host:port or *.sock)")
    parser.add_argument("--scheduler", default="auto",
                        choices=["auto", "auction", "greedy"])
    parser.add_argument("--scheduler-endpoint", default="",
                        help="PlacementSolver sidecar endpoint (host:port or "
                             "*.sock); empty = solve in-process (SURVEY §7: "
                             "the solver as a gRPC sidecar)")
    parser.add_argument("--preemption", action="store_true",
                        help="let higher-priority pending jobs displace "
                             "lower-priority submitted ones (auction only)")
    parser.add_argument("--policy", action="store_true",
                        help="enable the placement-policy engine: priority "
                             "classes, per-tenant fair share, bounded "
                             "preemption pool, backfill "
                             "(docs/scheduling-policy.md)")
    parser.add_argument("--shard", action="store_true",
                        help="enable sharded placement: partition/island "
                             "fan-out with per-shard encode+solve and "
                             "cross-shard gang reconciliation "
                             "(docs/sharding.md)")
    parser.add_argument("--shard-max-nodes", type=int, default=4096,
                        help="split partitions bigger than this across "
                             "shards (with --shard)")
    parser.add_argument("--shard-workers", type=int, default=2,
                        help="per-shard solve fan-out width (with --shard)")
    parser.add_argument("--policy-max-preemptions", type=int, default=64,
                        help="churn bound: incumbents displaceable per "
                             "scheduler tick (with --policy)")
    parser.add_argument("--no-incremental", action="store_true",
                        help="disable the event-driven incremental tick "
                             "(PR-11): cursor-scoped mirror sync, "
                             "dirty-set pending scan and warm-start "
                             "solve reuse — on by default, this flag "
                             "restores the full O(cluster) tick")
    parser.add_argument("--no-coldec", action="store_true",
                        help="disable the zero-object wire->column "
                             "decode of the bulk RPCs (ISSUE 14): on by "
                             "default, this flag keeps every response "
                             "on the pb2 object path")
    parser.add_argument("--no-mirror-frames", action="store_true",
                        help="disable the partitioned store commit "
                             "(ISSUE 19): worker-built commit frames "
                             "merged per writer partition — on by "
                             "default (engages only when the colpool "
                             "has workers), this flag keeps the serial "
                             "column scatter")
    parser.add_argument("--no-explain", action="store_true",
                        help="disable placement explainability (ISSUE "
                             "15): structured per-job reason codes, the "
                             "pressure ledger and /debug/schedz — on by "
                             "default, this flag restores the generic "
                             "'insufficient capacity' verdicts")
    parser.add_argument("--threads", type=int, default=2,
                        help="operator reconciler workers (--slurm-bridge-operator-threads)")
    parser.add_argument("--configurator-interval", type=float, default=30.0)
    parser.add_argument("--pod-sync-workers", type=int, default=10,
                        help="parallel pod converges per virtual-node sync "
                             "tick (the reference's --pod-sync-workers, "
                             "DefaultPodSyncWorkers=10)")
    parser.add_argument("--leader-lock", default="",
                        help="lease file enabling leader election; empty = no election")
    parser.add_argument("--leader-lease", default="",
                        help="coordination.k8s.io Lease name enabling leader "
                             "election across hosts (requires --kube-api); "
                             "takes precedence over --leader-lock")
    parser.add_argument("--state-file", default="",
                        help="durable store snapshot enabling restart resume "
                             "(the in-process stand-in for the K8s API's etcd)")
    parser.add_argument("--kubelet-port", type=int, default=-1,
                        help="kubelet-style HTTP logs API port (10250 in the "
                             "reference); -1 disables, an explicit 0 picks a "
                             "free port; a config-file port of 0 means disabled")
    parser.add_argument("--kubelet-config", default="",
                        help="virtual-node configuration YAML (ports, TLS, sync)")
    parser.add_argument("--kube-api", default="",
                        help="Kubernetes apiserver URL to watch SlurmBridgeJob "
                             "CRs on (e.g. https://10.0.0.1:443, or "
                             "'in-cluster' for the ServiceAccount env); "
                             "empty = no K8s edge")
    parser.add_argument("--kube-namespace", default="default")
    parser.add_argument("--kube-token-file", default="",
                        help="bearer-token file for --kube-api")
    parser.add_argument("--kube-ca-file", default="",
                        help="CA bundle for --kube-api TLS")
    add_observability_flags(parser, metrics_port_default=8080)
    parser.add_argument("--verbose", action="store_true")
    args = parser.parse_args(argv)

    setup_logging(verbose=args.verbose)
    log = logging.getLogger("sbt.bridge.main")

    vncfg = None
    if args.kubelet_config:
        from slurm_bridge_tpu_torch.bridge.vnconfig import load_vnode_config

        vncfg = load_vnode_config(args.kubelet_config)
    # Flag-over-file precedence (server.go:237-252): the file value applies
    # only when the flag was not actually passed. In the file, port 0 means
    # disabled; on the flag, an explicit 0 asks for an ephemeral port.
    passed = explicit_flags(parser, argv if argv is not None else sys.argv[1:])
    if "kubelet_port" in passed or vncfg is None:
        kubelet_port = args.kubelet_port
    else:
        kubelet_port = vncfg.port if vncfg.port > 0 else -1
    policy = None
    if args.policy:
        from slurm_bridge_tpu_torch.policy import PlacementPolicy, PolicyConfig

        if not args.preemption:
            log.warning(
                "--policy without --preemption: classes, fair share and "
                "backfill apply, but the preemption pool is inactive — "
                "a higher class cannot displace running work (pass "
                "--preemption to enable it)"
            )
        policy = PlacementPolicy(
            PolicyConfig(max_preemptions_per_tick=args.policy_max_preemptions)
        )
    shard = None
    if args.shard:
        from slurm_bridge_tpu_torch.shard import ShardConfig

        shard = ShardConfig(
            max_nodes_per_shard=args.shard_max_nodes,
            workers=args.shard_workers,
        )
    bridge = Bridge(
        args.endpoint,
        scheduler_backend=args.scheduler,
        solver_endpoint=args.scheduler_endpoint,
        preemption=args.preemption,
        policy=policy,
        shard=shard,
        incremental=not args.no_incremental,
        use_coldec=not args.no_coldec,
        mirror_frames=not args.no_mirror_frames,
        explain=not args.no_explain,
        state_file=args.state_file,
        configurator_interval=args.configurator_interval,
        operator_workers=args.threads,
        pod_sync_workers=args.pod_sync_workers,
        kubelet_port=None if kubelet_port < 0 else kubelet_port,
        kubelet_address=(vncfg.address if vncfg else "0.0.0.0"),
        kubelet_tls_cert=(vncfg.tls_cert_file if vncfg else ""),
        kubelet_tls_key=(vncfg.tls_key_file if vncfg else ""),
    )

    stop = threading.Event()
    ready = threading.Event()

    def check_ready() -> None:
        if not ready.is_set():
            raise RuntimeError("bridge components not started")

    httpd = start_observability(
        "sbt-bridge", args, ready_checks={"started": check_ready},
    )

    fatal: list[BaseException] = []

    kube_adapter = [None]
    kube_mirror = [None]

    def kube_config():
        from slurm_bridge_tpu_torch.bridge.kubeapi import KubeConfig

        if args.kube_api == "in-cluster":
            return KubeConfig.in_cluster()
        token = ""
        if args.kube_token_file:
            with open(args.kube_token_file) as f:
                token = f.read().strip()
        return KubeConfig(
            base_url=args.kube_api,
            namespace=args.kube_namespace,
            token=token,
            ca_file=args.kube_ca_file,
        )

    def start_kube_adapter() -> None:
        if not args.kube_api:
            return
        from slurm_bridge_tpu_torch.bridge.kubeapi import KubeApiAdapter, NodePodMirror

        cfg = kube_config()
        kube_adapter[0] = KubeApiAdapter(bridge, cfg).start()
        # kubectl visibility: one Node per partition + worker display pods;
        # advertise the vkhttp endpoint so the apiserver can proxy
        # `kubectl logs` to it (SBT_POD_IP = downward-API pod IP, like the
        # reference's VK_POD_IP env — configurator.go:188-293)
        kubelet_ep = None
        if bridge.kubelet_server is not None:
            import socket as _socket

            # precedence: downward-API env, then a CONCRETE configured bind
            # address (0.0.0.0 is not routable), then hostname resolution
            addr = os.environ.get("SBT_POD_IP", "")
            bind = getattr(bridge.kubelet_server, "address", "")
            if not addr and bind not in ("", "0.0.0.0", "::"):
                addr = bind
            if not addr:
                try:
                    addr = _socket.gethostbyname(_socket.gethostname())
                except OSError:
                    addr = "127.0.0.1"
            kubelet_ep = (addr, bridge.kubelet_server.port)
        kube_mirror[0] = NodePodMirror(
            bridge, cfg, kubelet_endpoint=kubelet_ep
        ).start()
        log.info("watching SlurmBridgeJob CRs on %s", cfg.base_url)

    def start_components() -> None:
        try:
            bridge.start()
            start_kube_adapter()
        except BaseException as exc:
            # Failing to start after winning the election must terminate the
            # daemon (as it would without election), not strand a zombie
            # that keeps renewing a lease it cannot serve.
            log.exception("bridge failed to start; exiting")
            fatal.append(exc)
            stop.set()
            return
        ready.set()
        log.info("bridge running against %s (scheduler=%s)", args.endpoint, args.scheduler)

    elector = None
    lost_lease: list[bool] = []

    def on_lost_leadership() -> None:
        # lost the lease ⇒ exit NON-ZERO (manager semantics) so an
        # on-failure supervisor restarts the replica as a standby; a
        # shutdown we initiated ourselves is not a loss
        if not stop.is_set():
            lost_lease.append(True)
            stop.set()

    if args.leader_lease:
        # the reference's actual primitive: a coordination.k8s.io Lease —
        # arbitrates replicas across hosts, not just one filesystem
        if not args.kube_api:
            parser.error("--leader-lease requires --kube-api")
        from slurm_bridge_tpu_torch.bridge.leader import KubeLeaseElector

        elector = KubeLeaseElector(
            kube_config(),
            args.leader_lease,
            on_started=start_components,
            on_stopped=on_lost_leadership,
        ).start()
        log.info("waiting for leadership on Lease %s", args.leader_lease)
    elif args.leader_lock:
        elector = LeaderElector(
            args.leader_lock,
            on_started=start_components,
            on_stopped=on_lost_leadership,
        ).start()
        log.info("waiting for leadership on %s", args.leader_lock)
    else:
        start_components()

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    log.info("shutting down")
    ready.clear()
    if kube_mirror[0] is not None:
        kube_mirror[0].stop()
    if kube_adapter[0] is not None:
        kube_adapter[0].stop()
    bridge.stop()
    if elector is not None:
        elector.stop()
    if httpd is not None:
        httpd.shutdown()
    return 1 if (fatal or lost_lease) else 0


if __name__ == "__main__":
    sys.exit(main())
