"""Bridge runtime — wires operator + configurator + scheduler + fetcher.

The reference runs five binaries (SURVEY.md §1); this facade runs their
equivalents as one process against a remote agent endpoint:

- :class:`BridgeOperator`   ↔ bridge-operator manager
- :class:`Configurator`     ↔ configurator daemon (spawning VK providers)
- :class:`PlacementScheduler` ↔ kube-scheduler's role, solver-backed
- :class:`FetchWorker`      ↔ the result-fetcher batch jobs

``submit()`` / ``wait()`` / ``logs()`` / ``cancel()`` give the kubectl-
shaped user surface (apply CR, watch status, logs -f, delete CR).
"""

from __future__ import annotations

import logging
import time

from slurm_bridge_tpu_torch.bridge.configurator import Configurator
from slurm_bridge_tpu_torch.bridge.controller import Ticker
from slurm_bridge_tpu_torch.bridge.fetcher import FetchWorker
from slurm_bridge_tpu_torch.bridge.objects import (
    BridgeJob,
    BridgeJobSpec,
    FetchState,
    JobState,
    Meta,
    Pod,
    validate_bridge_job,
)
from slurm_bridge_tpu_torch.bridge.operator import BridgeOperator, sizecar_name
from slurm_bridge_tpu_torch.bridge.scheduler import PlacementScheduler
from slurm_bridge_tpu_torch.bridge.store import NotFound, ObjectStore
from slurm_bridge_tpu_torch.obs.events import EventRecorder
from slurm_bridge_tpu_torch.parallel.backend import ensure_backend
from slurm_bridge_tpu_torch.solver.auction import AuctionConfig
from slurm_bridge_tpu_torch.wire import ServiceClient, dial
from slurm_bridge_tpu_torch.wire.rpc import (
    DEFAULT_METHOD_BUDGETS,
    TRANSIENT_CODES,
    RetryPolicy,
)

log = logging.getLogger("sbt.bridge")


class Bridge:
    def __init__(
        self,
        agent_endpoint: str,
        *,
        scheduler_backend: str = "auto",
        auction_config: AuctionConfig | None = None,
        preemption: bool = False,
        solver_endpoint: str = "",
        sharded: bool | None = None,
        scheduler_interval: float = 0.2,
        configurator_interval: float = 30.0,
        node_sync_interval: float = 0.25,
        operator_workers: int = 2,
        pod_sync_workers: int = 10,
        kubelet_port: int | None = None,
        kubelet_address: str = "127.0.0.1",
        kubelet_tls_cert: str = "",
        kubelet_tls_key: str = "",
        state_file: str = "",
        policy=None,
        shard=None,
        incremental: bool = True,
        use_coldec: bool = True,
        mirror_frames: bool = True,
        explain: bool = True,
        device=None,
    ):
        #: where the scheduler's device auction runs: None is the card (or
        #: SBT_BACKEND=cpu), "cpu" the host (parallel/backend.py); checked
        #: before anything is built, so a missing card fails here and not
        #: on the scheduler thread's first solve
        self.device = device
        ensure_backend(device)
        self.agent_endpoint = agent_endpoint
        self.store = ObjectStore()
        self.state_file = state_file
        self._persistence = None
        if state_file:
            from slurm_bridge_tpu_torch.bridge.persist import load_into

            restored = load_into(self.store, state_file)
            if restored:
                # resume tokens: the restored pods carry job_ids, so the
                # first provider sync re-associates them with live Slurm
                # state (SURVEY.md §5 checkpoint/resume)
                log.info("restored %d objects from %s", restored, state_file)
        self.events = EventRecorder()
        self.channel = dial(agent_endpoint)
        # DEADLINE_EXCEEDED joins the retryable set here because every
        # bridge submit carries a submitter_id the agent's journal-backed
        # ledger dedupes — a retry whose first attempt actually landed is
        # a no-op, not a duplicate Slurm job. Per-RPC budgets size the
        # retry deadline to each method's real cost and bound every
        # attempt, so one hung call can't eat the whole budget.
        self.client = ServiceClient(
            self.channel,
            "WorkloadManager",
            retry=RetryPolicy(
                codes=TRANSIENT_CODES,
                method_budgets=DEFAULT_METHOD_BUDGETS,
            ),
            # raw-bytes twins for the bulk RPCs (ISSUE 14): the mirror
            # decodes responses straight into columns when enabled
            coldec=use_coldec,
        )
        self.operator = BridgeOperator(
            self.store,
            agent_endpoint=agent_endpoint,
            events=self.events,
            workers=operator_workers,
        )
        self.configurator = Configurator(
            self.store,
            self.client,
            agent_endpoint=agent_endpoint,
            events=self.events,
            watch_interval=configurator_interval,
            node_sync_interval=node_sync_interval,
            pod_sync_workers=pod_sync_workers,
            incremental=incremental,
            use_coldec=use_coldec,
            mirror_frames=mirror_frames,
            # admission-window maintenance from the periodic inventory
            # probe (ROADMAP follow-up c); late-bound — providers only
            # sync after start(), by which time the scheduler exists
            inventory_listener=lambda part, nodes: (
                self.scheduler.note_inventory(part, nodes)
            ),
        )
        self.scheduler = PlacementScheduler(
            self.store,
            self.client,
            backend=scheduler_backend,
            auction_config=auction_config,
            events=self.events,
            preemption=preemption,
            solver_endpoint=solver_endpoint,
            sharded=sharded,
            policy=policy,
            shard=shard,
            incremental=incremental,
            explain=explain,
            device=device,
        )
        self._sched_ticker = Ticker(
            scheduler_interval, self.scheduler.tick, name="scheduler"
        )
        self.fetch_worker = FetchWorker(self.store, self.client)
        self.kubelet_server = None
        if kubelet_port is not None:
            from slurm_bridge_tpu_torch.bridge.vkhttp import VirtualKubeletServer

            self.kubelet_server = VirtualKubeletServer(
                self.configurator.providers,
                address=kubelet_address,
                port=kubelet_port,
                tls_cert_file=kubelet_tls_cert,
                tls_key_file=kubelet_tls_key,
            )
        self._started = False

    # ---- lifecycle ----

    def start(self) -> "Bridge":
        if self.state_file:
            from slurm_bridge_tpu_torch.bridge.persist import StorePersistence

            self._persistence = StorePersistence(self.store, self.state_file)
            # rebase: fold any restored snapshot+WAL into a fresh snapshot
            # under THIS incarnation, so the previous process's WAL tail
            # can never replay over state this process writes
            self._persistence.compact()
        self.configurator.start()
        self.operator.start()
        self._sched_ticker.start()
        self.fetch_worker.start()
        if self.kubelet_server is not None:
            self.kubelet_server.start()
        # streaming admission at ARRIVAL time (ISSUE 16): the sim harness
        # has called scheduler.admit() on each arrival since ISSUE 15;
        # the production bridge now does the same, event-driven off the
        # store watch, so an eligible interactive sizecar binds in
        # wall-clock milliseconds instead of waiting for the next
        # scheduler tick. admit() itself gates on role/phase/bound and
        # is a cheap no-op for everything else, so ADDED events for
        # non-sizecar pods cost one try_get.
        import threading

        self._admit_q = self.store.watch((Pod.KIND,))
        self._admit_thread = threading.Thread(
            target=self._pump_admissions, name="bridge-admit", daemon=True
        )
        self._admit_thread.start()
        self._started = True
        return self

    def _pump_admissions(self) -> None:
        q = self._admit_q
        while True:
            ev = q.get()
            if ev is None:  # stop() sentinel
                return
            if ev.type != "ADDED":
                continue
            try:
                self.scheduler.admit(ev.name)
            except Exception:
                # the fast path must never kill the pump: a miss (or any
                # race with a concurrent delete) falls through to the
                # batch tick, which remains the correctness path
                log.exception("arrival admit of %s failed", ev.name)

    def stop(self) -> None:
        if not self._started:
            return
        self.store.unwatch(self._admit_q)
        self._admit_q.put(None)  # wake the pump so the sentinel lands
        self._admit_thread.join(timeout=2.0)
        if self.kubelet_server is not None:
            self.kubelet_server.stop()
        self._sched_ticker.stop()
        if self.scheduler.shard is not None:
            self.scheduler.shard.close()  # shard solve pool teardown
        self.configurator.stop()
        self.operator.stop()
        self.fetch_worker.stop()
        if self._persistence is not None:
            self._persistence.close()  # final synchronous snapshot
            self._persistence = None
        self.client.close()
        self._started = False

    def __enter__(self) -> "Bridge":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- user surface (the kubectl shape) ----

    def submit(
        self,
        name: str,
        spec: BridgeJobSpec,
        *,
        labels: dict[str, str] | None = None,
    ) -> BridgeJob:
        """Create the CR. ``labels`` carry CR metadata — notably the
        policy's priority-class/tenant labels (docs/scheduling-policy.md),
        which the operator mirrors onto the sizecar pod."""
        job = BridgeJob(
            meta=Meta(name=name, labels=dict(labels or {})), spec=spec
        )
        validate_bridge_job(job)
        created = self.store.create(job)
        self.operator.enqueue(name)
        return created

    def get(self, name: str) -> BridgeJob:
        return self.store.get(BridgeJob.KIND, name)

    def list(self) -> list[BridgeJob]:
        return self.store.list(BridgeJob.KIND)

    def cancel(self, name: str) -> None:
        """Delete the CR: mark pods deleted so providers cancel their jobs,
        then drop the job object (cascade takes the rest)."""
        for pod in self.store.owned_by(Pod.KIND, name):
            def mark(p: Pod):
                p.meta.deleted = True

            try:
                self.store.mutate(Pod.KIND, pod.name, mark)
            except NotFound:
                pass
        # providers cancel + delete marked pods on their next sync
        self.configurator.sync_now()
        try:
            self.store.delete(BridgeJob.KIND, name)
        except NotFound:
            pass

    def wait(
        self,
        name: str,
        *,
        timeout: float = 60.0,
        until: tuple[str, ...] = JobState.TERMINAL,
        fetch_done: bool = False,
    ) -> BridgeJob:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            job = self.get(name)
            if job.status.state in until:
                if not fetch_done or not job.spec.result_to or job.status.fetch_result in (
                    FetchState.SUCCEEDED,
                    FetchState.FAILED,
                ):
                    return job
            time.sleep(0.05)
        raise TimeoutError(
            f"job {name} did not reach {until} in {timeout}s "
            f"(state={self.get(name).status.state})"
        )

    def logs(self, name: str, *, follow: bool = False):
        """Stream the job's stdout via its partition provider
        (kubectl logs shape, §3.4)."""
        pod = self.store.get(Pod.KIND, sizecar_name(name))
        provider = self.configurator.providers.get(pod.spec.partition)
        if provider is None:
            raise NotFound(f"no provider for partition {pod.spec.partition!r}")
        return provider.pod_logs(pod.name, follow=follow)

    def converge_once(self) -> None:
        """Drive one full control loop synchronously (tests; also handy for
        batch usage without background tickers)."""
        self.configurator.reconcile()
        self.scheduler.tick()
        self.configurator.sync_now()
        for job in self.list():
            self.operator.enqueue(job.meta.name)
