"""Configurator — partition discovery → one virtual-node provider each.

Reference parity: pkg/configurator/configurator.go. A ticker (default 30s,
:94-118) lists partitions over the agent RPC, diffs them against the
providers currently registered (the reference diffs against nodes labeled
``type=slurm-agent-virtual-kubelet`` and creates/deletes one VK *pod* per
partition, :120-184; here each partition gets an in-process
:class:`VirtualNodeProvider` plus its sync ticker), and converges.
"""

from __future__ import annotations

import logging

from slurm_bridge_tpu_torch.bridge.controller import Ticker
from slurm_bridge_tpu_torch.bridge.store import ObjectStore
from slurm_bridge_tpu_torch.bridge.vnode import VirtualNodeProvider
from slurm_bridge_tpu_torch.obs.events import EventRecorder, Reason
from slurm_bridge_tpu_torch.obs.tracing import TRACER, with_current_span
from slurm_bridge_tpu_torch.wire import ServiceClient, pb

log = logging.getLogger("sbt.configurator")

DEFAULT_WATCH_INTERVAL_S = 30.0  # cmd/configurator/configurator.go:63


class Configurator:
    def __init__(
        self,
        store: ObjectStore,
        client: ServiceClient,
        *,
        agent_endpoint: str = "",
        events: EventRecorder | None = None,
        watch_interval: float = DEFAULT_WATCH_INTERVAL_S,
        node_sync_interval: float = 1.0,
        pod_sync_workers: int = 10,
        provider_inventory_ttl: float | None = None,
        provider_status_interval: float | None = None,
        incremental: bool = False,
        use_coldec: bool = True,
        mirror_frames: bool = True,
        inventory_listener=None,
    ):
        self.store = store
        self.client = client
        self.agent_endpoint = agent_endpoint
        self.events = events or EventRecorder()
        #: ``node_sync_interval <= 0`` disables the per-partition sync
        #: tickers entirely — the embedder (e.g. the sim harness, which
        #: must stay single-threaded for determinism) drives ``sync_now()``
        self.node_sync_interval = node_sync_interval
        self.pod_sync_workers = pod_sync_workers
        #: forwarded to each provider; ``None`` keeps the provider default
        #: (the sim sets 0 so no wall-clock cache window leaks in)
        self.provider_inventory_ttl = provider_inventory_ttl
        #: forwarded heartbeat interval; ``None`` keeps the provider
        #: default (the sim passes inf so steady ticks stay write-free
        #: regardless of how slow the box runs the tick)
        self.provider_status_interval = provider_status_interval
        #: event-driven incremental mirror (PR-11), forwarded per provider
        self.incremental = incremental
        #: zero-object wire->column decode (ISSUE 14), forwarded per
        #: provider; off = the pb2 bulk path byte-for-byte
        self.use_coldec = use_coldec
        #: partitioned commit frames (ISSUE 19), forwarded per provider;
        #: engages only when a colpool is active — off (or width 0) runs
        #: the serial column scatter byte-for-byte
        self.mirror_frames = mirror_frames
        #: per-provider inventory-change callback (ISSUE 15 /
        #: ROADMAP streaming-admission follow-up c): the scheduler's
        #: admission-window maintenance seam, forwarded to every
        #: provider this configurator spawns
        self.inventory_listener = inventory_listener
        self.providers: dict[str, VirtualNodeProvider] = {}
        self._tickers: dict[str, Ticker] = {}
        self._watch = Ticker(watch_interval, self.reconcile, name="configurator")

    def start(self) -> None:
        self.reconcile()
        self._watch.start()

    def stop(self) -> None:
        self._watch.stop()
        for t in self._tickers.values():
            t.stop()
        for p in self.providers.values():
            # shut the pod-sync pools: their threads are non-daemon and
            # would outlive a stopped Bridge (long-lived embedders/tests
            # cycling bridges would accumulate 10 idle threads per
            # partition per cycle). close(), NOT deregister() — a clean
            # stop (leader step-down, embedder cycling) must not delete
            # the VirtualNodes: the NodePodMirror propagates deletions to
            # the real apiserver and the nodes would flap across restarts
            # (ADVICE r5 #1); only _remove_partition deletes nodes.
            p.close()

    def reconcile(self) -> None:
        """Diff live partitions vs registered providers (:120-184)."""
        with TRACER.span("configurator.reconcile") as span:
            live = set(self.client.Partitions(pb.PartitionsRequest()).partitions)
            added = removed = 0
            for partition in sorted(live - self.providers.keys()):
                self._add_partition(partition)
                added += 1
            for partition in sorted(self.providers.keys() - live):
                self._remove_partition(partition)
                removed += 1
            span.count("partitions", len(live))
            if added:
                span.count("added", added)
            if removed:
                span.count("removed", removed)

    def sync_now(self) -> None:
        """Force one synchronous provider sync (tests/converge helpers).

        Partitions converge in parallel (PR-4): each provider sync can
        block on agent RPCs, and the forced-converge path used to pay the
        sum of all partitions' cold-start fan-outs serially. With
        ``pod_sync_workers == 1`` (the simulator's deterministic mode)
        the syncs stay serial in sorted-partition order.
        """
        with TRACER.span("configurator.sync_now") as span:
            providers = [self.providers[p] for p in sorted(self.providers)]
            span.count("providers", len(providers))
            if len(providers) <= 1 or self.pod_sync_workers == 1:
                for p in providers:
                    p.sync()
                return
            from concurrent.futures import ThreadPoolExecutor

            def sync_one(p, _parent=span):
                # pool workers start with an empty contextvar: seed the
                # sync_now span as parent so each provider's vnode.sync
                # span lands inside the tick trace
                with with_current_span(_parent):
                    p.sync()

            # transient pool: sync_now is the forced-converge path, not
            # the 250 ms ticker (each partition's ticker already runs in
            # its own thread in steady state) — churn here is irrelevant
            with ThreadPoolExecutor(
                max_workers=min(8, len(providers)),
                thread_name_prefix="partition-sync",
            ) as pool:
                list(pool.map(sync_one, providers))

    def _add_partition(self, partition: str) -> None:
        kwargs = {}
        if self.provider_inventory_ttl is not None:
            kwargs["inventory_ttl"] = self.provider_inventory_ttl
        if self.provider_status_interval is not None:
            kwargs["status_interval"] = self.provider_status_interval
        provider = VirtualNodeProvider(
            self.store,
            self.client,
            partition,
            agent_endpoint=self.agent_endpoint,
            events=self.events,
            sync_workers=self.pod_sync_workers,
            incremental=self.incremental,
            use_coldec=self.use_coldec,
            mirror_frames=self.mirror_frames,
            inventory_listener=self.inventory_listener,
            **kwargs,
        )
        provider.register()
        self.providers[partition] = provider
        if self.node_sync_interval > 0:
            ticker = Ticker(
                self.node_sync_interval, provider.sync, name=f"vnode-{partition}"
            )
            ticker.start()
            self._tickers[partition] = ticker
        log.info("partition %s: virtual node %s up", partition, provider.node_name)

    def _remove_partition(self, partition: str) -> None:
        ticker = self._tickers.pop(partition, None)
        if ticker:
            ticker.stop()
        provider = self.providers.pop(partition, None)
        if provider:
            provider.deregister()
            self.events.event(
                None, Reason.NODE_GONE, f"partition {partition} removed", warning=True
            )
        log.info("partition %s: virtual node removed", partition)
