"""BridgeOperator — the BridgeJob reconciler.

Reference parity: pkg/slurm-bridge-operator/slurmbridgejob_controller.go.
The reconcile branches exactly as the reference's Reconcile (:104-159):
validate → if finished, converge the result-fetch job; else ensure the
sizecar pod, sync CR status from it, and maintain per-sub-job worker pods.

Sizecar sizing (pod.go:18-68): parse ``#SBATCH`` headers out of the script
(extractBatchResourcesFromScript, parse.go:30-124), let explicit spec
fields override them, default 1 node / 1 cpu / 1024 MB-per-cpu
(pod.go:91-95); cpu multiplies by ntasks × array length
(genResourceListForPod :143-162).
"""

from __future__ import annotations

import logging
from functools import lru_cache
import os
import queue
import time

import numpy as np

from slurm_bridge_tpu_torch.bridge.columns import (
    CR_STATE_OF_PHASE,
    JOBSTATUS_BY_CODE,
    STATE_CODE,
    STATE_STRS,
    heap_iso,
    heap_iso_bulk,
)
from slurm_bridge_tpu_torch.bridge.controller import Controller, Result
from slurm_bridge_tpu_torch.bridge.freeze import (
    FrozenDict,
    FrozenList,
    fast_new,
    fast_replace,
    frozen_new,
    frozen_replace,
)
from slurm_bridge_tpu_torch.bridge.objects import (
    BridgeJob,
    ContainerStatus,
    FetchFile,
    FetchJob,
    FetchState,
    JobState,
    Meta,
    Pod,
    PodPhase,
    PodRole,
    PodSpec,
    PodStatus,
    SubjobStatus,
    ValidationError,
    new_uid,
    validate_bridge_job,
    validate_job_fields,
)
from slurm_bridge_tpu_torch.bridge.statusmap import (
    container_status_for,
    job_state_for_pod_phase,
)
from slurm_bridge_tpu_torch.bridge.store import AlreadyExists, NotFound, ObjectStore
from slurm_bridge_tpu_torch.core.arrays import array_len
from slurm_bridge_tpu_torch.core.sbatch import extract_batch_resources
from slurm_bridge_tpu_torch.core.types import JobDemand
from slurm_bridge_tpu_torch.obs.events import EventRecorder, Reason
from slurm_bridge_tpu_torch.obs.metrics import REGISTRY
from slurm_bridge_tpu_torch.obs.tracing import TRACER
from slurm_bridge_tpu_torch.parallel import colpool, writeops
from slurm_bridge_tpu_torch.policy.classes import (
    CLASS_LABEL as _CLASS_LABEL,
    TENANT_LABEL as _TENANT_LABEL,
)

log = logging.getLogger("sbt.operator")

RESULT_REQUEUE_S = 30.0  # result-poll requeue (slurmbridgejob_controller.go:141)

_reconciles = REGISTRY.counter("sbt_operator_reconciles_total", "operator reconciles")
_sweeps = REGISTRY.counter(
    "sbt_operator_sweeps_total", "dirty-set batch sweeps (PR-4 cold-start path)"
)
_reconcile_seconds = REGISTRY.histogram(
    "sbt_operator_reconcile_seconds",
    "one single-key reconcile, or one whole dirty-set sweep pass",
)
_sweep_pool_rows = REGISTRY.counter(
    "sbt_operator_sweep_pool_rows_total",
    "sizecar creates whose demand/label resolution ran in colpool "
    "workers (ISSUE 18 write-side offload)",
)

#: sizecar creates per _OP_BUILD_ROWS frame: big enough that the frame
#: header/pack overhead amortizes, small enough that a 100k-create storm
#: still fans out across every worker
_BUILD_CHUNK = 2048

#: CR state transitions worth an event (UpdateSBJStatus's recorder calls)
_STATE_REASONS = {
    JobState.RUNNING: Reason.JOB_RUNNING,
    JobState.SUCCEEDED: Reason.JOB_SUCCEEDED,
    JobState.FAILED: Reason.JOB_FAILED,
}

#: shared empty job_infos for worker pods — immutable, so aliasing across
#: 45k creates per sweep is safe and skips a FrozenList build each
_EMPTY_FROZEN_LIST = FrozenList()
#: shared empty annotation map for born-frozen creates (immutable, so
#: sharing across pods is safe; writers always build replacement dicts)
_EMPTY_FROZEN_DICT = FrozenDict()

#: CR-state int8 codes the columnar sweep uses
_ST_RUNNING = STATE_CODE[JobState.RUNNING]
_ST_SUCCEEDED = STATE_CODE[JobState.SUCCEEDED]
_ST_FAILED = STATE_CODE[JobState.FAILED]
_POD_PHASE_PENDING = 0  # columns.PHASE_CODE[PodPhase.PENDING]
#: JobStatus display names by code (container reasons)
_STATUS_NAME = tuple(s.name for s in JOBSTATUS_BY_CODE)
_STATUS_NAME_ARR = np.empty(len(_STATUS_NAME), dtype=object)
_STATUS_NAME_ARR[:] = _STATUS_NAME

#: dirty sets at least this large AND covering ≥¼ of the stored CRs read
#: via two bulk list() dict builds instead of per-key try_get (3 locked
#: lookups × 45k owners is 135k lock round-trips on a cold-start sweep).
#: Module-level so the equivalence test can drop it and fuzz the bulk
#: branch too.
_BULK_SWEEP_THRESHOLD = 512


def sizecar_name(job_name: str) -> str:
    return f"{job_name}-sizecar"


def worker_name(job_name: str) -> str:
    return f"{job_name}-worker"


def fetch_job_name(job_name: str) -> str:
    return f"{job_name}-fetch"


@lru_cache(maxsize=512)
def _parsed_header(script: str):
    """Memoized #SBATCH header parse: a 500k-arrival storm submits the
    same handful of script bodies over and over, and re-parsing the
    headers per job was ~0.4 s per 100k sweeps (ISSUE 14)."""
    return extract_batch_resources(script).demand


def demand_for_job(job: BridgeJob) -> JobDemand:
    """Script #SBATCH headers, overridden by explicit spec fields, with
    the reference defaults (pod.go:18-95) — the object-path wrapper over
    :func:`demand_for_spec`."""
    return demand_for_spec(job.meta.name, job.spec)


def demand_for_spec(name: str, spec) -> JobDemand:
    """The demand build from (job name, spec) directly — what the
    columnar sweep calls with values gathered from the job table, so a
    100k-create storm never materializes the BridgeJob views the old
    per-create ``jt.view()`` path paid 2.5M ``_frozen_shell`` calls for
    (ISSUE 16). Born FROZEN via ``frozen_new`` — every field scalar, so
    commit-time freeze stops at one probe instead of a 19-field walk per
    pod (ISSUE 14; the storm creates one demand per arrival)."""
    hdr = _parsed_header(spec.sbatch_script)
    return frozen_new(
        JobDemand,
        partition=spec.partition or hdr.partition,
        script=spec.sbatch_script,
        job_name=name,
        run_as_user=spec.run_as_user,
        run_as_group=spec.run_as_group,
        array=spec.array or hdr.array,
        cpus_per_task=spec.cpus_per_task or hdr.cpus_per_task or 1,
        ntasks=spec.ntasks or hdr.ntasks or 1,
        ntasks_per_node=spec.ntasks_per_node or hdr.ntasks_per_node,
        nodes=spec.nodes or hdr.nodes or 1,
        working_dir=spec.working_dir or hdr.working_dir,
        mem_per_cpu_mb=spec.mem_per_cpu_mb or hdr.mem_per_cpu_mb or 1024,
        gres=spec.gres or hdr.gres,
        licenses=spec.licenses,
        time_limit_s=hdr.time_limit_s,
        priority=spec.priority,
        nodelist=(),
    )


class BridgeOperator:
    def __init__(
        self,
        store: ObjectStore,
        *,
        agent_endpoint: str = "",
        events: EventRecorder | None = None,
        workers: int = 1,
    ):
        self.store = store
        self.agent_endpoint = agent_endpoint
        self.events = events or EventRecorder()
        self.controller = Controller(
            name="bridge-operator", reconcile=self.reconcile, workers=workers
        )
        #: sweep-side validation cache: name -> the exact spec object that
        #: passed validation. Validation is a pure function of (name,
        #: spec), specs are immutable snapshots (any respec is a NEW
        #: object), and holding the reference pins the address so an `is`
        #: check can never alias a recycled id. The single-key oracle
        #: still validates from scratch every time.
        self._validated_specs: dict[str, object] = {}

    # ---- wiring ----

    def start(self) -> None:
        self.controller.start()
        self._watch_q = self.store.watch((BridgeJob.KIND, Pod.KIND, FetchJob.KIND))
        import threading

        threading.Thread(target=self._pump_events, daemon=True).start()

    def _pump_events(self) -> None:
        """Coalesce watch events into a dirty owner set and sweep it in
        batch (PR-4): a cold-start storm of 100k owned-object events
        collapses into a handful of sweep passes instead of 100k queued
        single reconciles. Keys the sweep cannot settle (validation
        failures, finished jobs, commit conflicts) go to the controller
        queue, whose single-key :meth:`reconcile` remains the correctness
        oracle — as does the whole dirty set if a sweep pass dies."""
        while True:
            ev = self._watch_q.get()
            if ev is None:
                return
            dirty: set[str] = set()
            self._collect_owner(ev, dirty)
            # drain whatever the storm has already queued — one sweep
            # per burst, not one reconcile per event
            while True:
                try:
                    ev = self._watch_q.get_nowait()
                except queue.Empty:
                    break
                if ev is None:
                    return
                self._collect_owner(ev, dirty)
            if not dirty:
                continue
            try:
                for key in self.sweep(dirty):
                    self.controller.enqueue(key)
            except Exception:
                log.exception(
                    "sweep of %d keys failed; requeueing singly", len(dirty)
                )
                for key in sorted(dirty):
                    self.controller.enqueue(key)

    def _collect_owner(self, ev, dirty: set[str]) -> None:
        """BridgeJobs reconcile as themselves; owned objects via their
        owner ref (SetupWithManager's Owns(&Pod{}),
        slurmbridgejob_controller.go:204). The conventional
        ``-sizecar``/``-worker``/``-fetch`` name suffix resolves the owner
        WITHOUT a store read — only unrecognized names pay the ``try_get``
        (a cold-start tick pumps 100k+ events through here)."""
        if ev.kind == BridgeJob.KIND:
            dirty.add(ev.name)
            return
        owner = self._owner_from_name(ev.name)
        if not owner:
            obj = self.store.try_get(ev.kind, ev.name)
            owner = obj.meta.owner if obj is not None else ""
        if owner:
            dirty.add(owner)

    def _owner_from_name(self, obj_name: str) -> str:
        for suffix in ("-sizecar", "-worker", "-fetch"):
            if obj_name.endswith(suffix):
                return obj_name[: -len(suffix)]
        return ""

    def stop(self) -> None:
        if hasattr(self, "_watch_q"):
            self.store.unwatch(self._watch_q)
            self._watch_q.put(None)  # unblock the pump thread
        self.controller.stop()

    def enqueue(self, job_name: str) -> None:
        self.controller.enqueue(job_name)

    # ---- the reconcile ----

    def reconcile(self, job_name: str) -> Result | None:
        # no span per job: the controller thread's ``{name}.reconcile``
        # span covers its keys, and the sweep counts the ones it settles
        t0 = time.perf_counter()
        try:
            return self._reconcile(job_name)
        finally:
            _reconcile_seconds.observe(time.perf_counter() - t0)

    def _reconcile(self, job_name: str) -> Result | None:
        _reconciles.inc()
        job = self.store.try_get(BridgeJob.KIND, job_name)
        if job is None or job.meta.deleted:
            # drop the sweep's validation-cache pin here too — a deletion
            # settled by the single-key path must not leak the spec object
            self._validated_specs.pop(job_name, None)
            return None
        try:
            validate_bridge_job(job)
        except ValidationError as e:
            self._set_state(job_name, JobState.FAILED, reason=str(e))
            self.events.event(job, Reason.JOB_FAILED, str(e), warning=True)
            return None

        if job.finished:
            return self._reconcile_result(job)
        self._reconcile_sizecar(job)
        self._sync_status(job_name)
        self._reconcile_worker(job_name)
        return None

    # ---- the dirty-set batch sweep (PR-4 cold-start path) ----

    def sweep(self, names, *, settle: bool = False) -> list[str]:
        """Batch reconcile of a dirty owner set — the cold-start path.

        Semantically N single reconciles (the fuzzed equivalence test in
        tests/test_operator_sweep.py holds it to exactly that), but with
        batched store traffic: reads run against current snapshots, then
        ALL sizecar/worker creates land in one :meth:`~ObjectStore.
        create_batch` and ALL CR status replacements plus worker-pod
        writes land in one :meth:`~ObjectStore.update_batch` — two lock
        acquisitions per sweep where the single-key path paid ~5 per
        owner, 45k owners deep on a cold-start tick.

        Returns the keys the sweep deliberately does NOT settle —
        validation failures, finished jobs (the result-fetch path owns
        requeue timing), vanished sizecars, and commit conflicts. Callers
        route those to :meth:`reconcile`, the single-key correctness
        oracle and the fallback for everything unusual. With ``settle``
        the sweep does so itself, in order and inside its span (counted
        as its ``reconciles`` and ``reconcile_ms``), and returns nothing.
        """
        with TRACER.span("operator.sweep") as span:
            jt = self.store.table(BridgeJob.KIND)
            pt = self.store.table(Pod.KIND)
            if jt is not None and pt is not None:
                slow = self._sweep_cols(span, names, jt, pt)
            else:
                slow = self._sweep(span, names)
            if not settle:
                return slow
            t0 = time.perf_counter()
            for key in slow:
                self.reconcile(key)
            span.count("reconciles", len(slow))
            span.count("reconcile_ms", (time.perf_counter() - t0) * 1e3)
            return []

    def _sweep(self, span, names) -> list[str]:
        t0 = time.perf_counter()
        _sweeps.inc()
        slow: list[str] = []
        #: (pod to create, owning job when the create deserves an event)
        creates: list[tuple[Pod, BridgeJob | None]] = []
        cr_updates: list[tuple[BridgeJob, BridgeJob]] = []  # (before, after)
        worker_updates: list[Pod] = []
        ordered = sorted(set(names))
        if (
            len(ordered) >= _BULK_SWEEP_THRESHOLD
            and len(ordered) * 4 >= self.store.count(BridgeJob.KIND)
        ):
            # bulk reads: a cold-start sweep touches most of the store,
            # and 3 snapshot lookups × 45k owners is 135k lock round-trips
            # — two list() calls and dict probes replace them all. Gated
            # on the dirty set covering ≥¼ of the CRs, so a mid-size burst
            # against a huge steady-state store does NOT materialize the
            # whole store to answer a few hundred lookups.
            get_job = {
                o.meta.name: o for o in self.store.list(BridgeJob.KIND)
            }.get
            get_pod = {o.meta.name: o for o in self.store.list(Pod.KIND)}.get
        else:
            get_job = lambda n: self.store.try_get(BridgeJob.KIND, n)  # noqa: E731
            get_pod = lambda n: self.store.try_get(Pod.KIND, n)  # noqa: E731
        validated = self._validated_specs
        for name in ordered:
            job = get_job(name)
            if job is None or job.meta.deleted:
                validated.pop(name, None)
                continue
            if validated.get(name) is not job.spec:
                try:
                    validate_bridge_job(job)
                except ValidationError:
                    slow.append(name)
                    continue
                validated[name] = job.spec
            if job.finished:
                slow.append(name)
                continue
            sizecar = get_pod(sizecar_name(name))
            if sizecar is None:
                if job.status.subjobs:
                    # pod vanished but sub-jobs exist ⇒ Failed — the
                    # oracle owns the state write + warning event
                    slow.append(name)
                    continue
                sizecar = self._build_sizecar(job)
                creates.append((sizecar, job))
            after = self._cr_replacement(job, sizecar)
            if after is not None:
                cr_updates.append((job, after))
            eff = after if after is not None else job
            if not eff.status.subjobs:
                continue
            containers = FrozenList(
                container_status_for(info) for info in sizecar.status.job_infos
            )
            existing = get_pod(worker_name(name))
            if existing is None:
                creates.append(
                    (self._build_worker(job, sizecar, containers), None)
                )
            else:
                repl = self._worker_replacement(existing, sizecar, containers)
                if repl is not None:
                    worker_updates.append(repl)
        if creates:
            results = self.store.create_batch(
                [pod for pod, _ in creates], site="operator.sweep"
            )
            for (pod, job), res in zip(creates, results):
                # AlreadyExists loses the create race exactly like the
                # single path: silently (and without the event)
                if job is not None and not isinstance(res, Exception):
                    self.events.event(
                        job, Reason.POD_CREATED,
                        f"sizecar pod {pod.meta.name} created",
                    )
        updates = [after for _, after in cr_updates] + worker_updates
        if updates:
            results = self.store.update_batch(updates, site="operator.sweep")
            for (before, _), res in zip(cr_updates, results):
                if isinstance(res, Exception):
                    # racing writer: the oracle re-reads and retries
                    slow.append(before.meta.name)
                    continue
                if self._emit_state_events(before, res):
                    # just finished with a possible result request
                    slow.append(before.meta.name)
            for pod, res in zip(worker_updates, results[len(cr_updates):]):
                if isinstance(res, Exception):
                    slow.append(pod.meta.owner)
        span.count("owners", len(ordered))
        span.count("creates", len(creates))
        span.count("updates", len(updates))
        span.count("slow", len(set(slow)))
        _reconcile_seconds.observe(time.perf_counter() - t0)
        return sorted(set(slow))

    # ---- the columnar sweep (PR-6) ----

    def _worker_labels(self, partition: str) -> FrozenDict:
        """Interned per-partition worker labels — immutable, so aliasing
        across 45k creates per sweep is safe (content-equal to the
        oracle's per-pod dict)."""
        cache = getattr(self, "_worker_label_cache", None)
        if cache is None:
            cache = self._worker_label_cache = {}
        fd = cache.get(partition)
        if fd is None:
            fd = cache[partition] = FrozenDict(
                {"role": PodRole.WORKER, "partition": partition}
            )
        return fd

    def _start_sizecar_build(self, creates: list[tuple]):
        """Kick ``_OP_BUILD_ROWS`` for the sweep's sizecar creates —
        non-blocking (``colpool.start_frames``), so the header parse +
        override resolution runs in the workers while the caller
        finishes the locked capture. Returns the job handle, or ``None``
        when there is nothing to build or no pool (1-core box: the
        serial arm runs with zero overhead)."""
        if not creates:
            return None
        pool = colpool.active_pool()
        if pool is None:
            return None
        chunks = [
            creates[lo : lo + _BUILD_CHUNK]
            for lo in range(0, len(creates), _BUILD_CHUNK)
        ]
        return pool.start_frames(
            colpool._OP_BUILD_ROWS, chunks, writeops.pack_build_chunk
        )

    def _built_sizecar_rows(
        self, creates: list[tuple], frames: list[bytes]
    ) -> tuple[list, list]:
        """Reassemble the worker-resolved columns into the frozen
        demands + label dicts the create scatter writes — field-for-
        field what the serial ``demand_for_spec`` + label build
        produces (fuzz-pinned), with the parent supplying everything
        that never rode the wire (owner/job_name, run_as_user/group,
        licenses, priority, the label insertion order)."""
        sc_demand: list = []
        sc_labels: list = []
        i = 0
        for lo in range(0, len(creates), _BUILD_CHUNK):
            chunk = creates[lo : lo + _BUILD_CHUNK]
            cols = writeops.unpack_build_result(frames[i])
            i += 1
            for j, (o, s, jl) in enumerate(chunk):
                dem = frozen_new(
                    JobDemand,
                    partition=cols["partition"][j],
                    script=s.sbatch_script,
                    job_name=o,
                    run_as_user=s.run_as_user,
                    run_as_group=s.run_as_group,
                    array=cols["array"][j],
                    cpus_per_task=cols["cpus_per_task"][j],
                    ntasks=cols["ntasks"][j],
                    ntasks_per_node=cols["ntasks_per_node"][j],
                    nodes=cols["nodes"][j],
                    working_dir=cols["working_dir"][j],
                    mem_per_cpu_mb=cols["mem_per_cpu_mb"][j],
                    gres=cols["gres"][j],
                    licenses=s.licenses,
                    time_limit_s=cols["time_limit_s"][j],
                    priority=s.priority,
                    nodelist=(),
                )
                sc_demand.append(dem)
                labels = {
                    "role": PodRole.SIZECAR,
                    "partition": dem.partition,
                    "request-cpu": cols["request_cpu"][j],
                    "request-memory-mb": cols["request_mem"][j],
                }
                if jl:
                    for key in (_TENANT_LABEL, _CLASS_LABEL):
                        val = jl.get(key)
                        if val:
                            labels[key] = val
                sc_labels.append(FrozenDict(labels))
        return sc_demand, sc_labels

    def _sweep_cols(self, span, names, jt, pt) -> list[str]:
        """The sweep on columns, vectorized: one locked scan classifies
        every owner with NumPy column masks (the per-owner Python loop is
        gone — raw-field compares instead of 45k SubjobStatus/
        ContainerStatus builds + dict equality), captures the values for
        changed rows as gathered arrays (copies — heap indices would go
        stale if a concurrent writer compacts a heap), then commits land
        as batched row-writes. Owners with shapes the fast path doesn't
        model (multi-sub-job arrays) re-enter :meth:`_sweep`, the
        object-path oracle, at the end — so the two can never drift on
        the unusual cases either.
        """
        from slurm_bridge_tpu_torch.bridge.colstore import object_array as oarr
        from slurm_bridge_tpu_torch.bridge.colstore import object_full

        t0 = time.perf_counter()
        _sweeps.inc()
        slow: list[str] = []
        #: (owner name, job spec, job labels) — demand parse + pod-row
        #: build happen at commit time, outside the lock
        sizecar_creates: list[tuple] = []
        ordered = sorted(set(names))
        n = len(ordered)
        validated = self._validated_specs
        jc, pc = jt.cols, pt.cols
        h = pt.adapter.infos
        sh = jt.adapter.subjobs
        ch = pt.adapter.containers

        with self.store.locked():
            jrows = jt.rows_for(ordered)
            found = jrows >= 0
            jr = np.where(found, jrows, 0)
            alive = found & ~jc.deleted[jr]
            # validation gate (python: identity-cached per name)
            ok = np.zeros(n, bool)
            vget, vpop = validated.get, validated.pop
            spec_col = jc.spec
            for i in np.nonzero(alive)[0].tolist():
                name = ordered[i]
                spec = spec_col[jr[i]]
                if vget(name) is not spec:
                    try:
                        validate_job_fields(name, spec)
                    except ValidationError:
                        slow.append(name)
                        continue
                    validated[name] = spec
                ok[i] = True
            for i in np.nonzero(~alive)[0].tolist():
                vpop(ordered[i], None)
            state = jc.state[jr]
            terminal = (state == _ST_SUCCEEDED) | (state == _ST_FAILED)
            slow.extend(ordered[i] for i in np.nonzero(ok & terminal)[0].tolist())
            act0 = ok & ~terminal
            slen = jc.slen[jr].astype(np.int64)
            srows = pt.rows_for([sizecar_name(nm) for nm in ordered])
            has_s = srows >= 0
            sr = np.where(has_s, srows, 0)
            missing = act0 & ~has_s
            m_slow = missing & (slen > 0)
            slow.extend(ordered[i] for i in np.nonzero(m_slow)[0].tolist())
            m_create = missing & (slen == 0)
            # capture (owner, spec, job labels) only — the demand parse,
            # label build and pod materialization all run OUTSIDE the
            # lock, and the create lands as a row-write (no Pod objects,
            # no create_batch freeze-walk: ~100k ``jt.view`` shells per
            # cold sweep gone, ISSUE 16)
            for i in np.nonzero(m_create)[0].tolist():
                row = int(jr[i])
                sizecar_creates.append(
                    (ordered[i], spec_col[row], jc.labels[row])
                )
            # kick the worker-pool demand/label resolution NOW (ISSUE
            # 18): specs are immutable snapshots, so the fan-out threads
            # pack them safely while this thread still holds the lock —
            # the builds overlap the whole CR/worker capture below, and
            # the commit block collects (or falls back serially)
            build_job = self._start_sizecar_build(sizecar_creates)
            act = (act0 & has_s) | m_create
            pod_phase = np.where(has_s, pc.phase[sr], _POD_PHASE_PENDING)
            ilen = np.where(has_s, pc.ilen[sr], 0).astype(np.int64)
            pod_reason = np.where(has_s, pc.reason[sr], "")
            srow_node = np.where(has_s, pc.node[sr], "")
            fb = act & ((ilen > 1) | (slen > 1))
            obj_fallback = [ordered[i] for i in np.nonzero(fb)[0].tolist()]
            act &= ~fb
            new_state = CR_STATE_OF_PHASE[pod_phase]
            old_reason = jc.reason[jr]
            reason_changed = (
                act & (pod_reason != "") & (old_reason != pod_reason)
            )
            new_reason = np.where(reason_changed, pod_reason, old_reason)
            old_ep = jc.endpoint[jr]
            if self.agent_endpoint:
                ep_changed = act & (old_ep == "")
                new_ep = np.where(ep_changed, self.agent_endpoint, old_ep)
            else:
                ep_changed = np.zeros(n, bool)
                new_ep = old_ep
            one = act & (ilen == 1)
            ii = np.where(one, pc.istart[sr], 0)
            fresh = one & (slen == 0)
            both = one & (slen == 1)
            si = np.where(both, jc.sstart[jr], 0)
            neq = both & (
                (sh.id[si] != h.id[ii])
                | (sh.state[si] != h.state[ii])
                | (sh.run_time[si] != h.run_time[ii])
                | (sh.array_id[si] != h.array_id[ii])
                | (sh.exit_code[si] != h.exit_code[ii])
                | (sh.stdout[si] != h.stdout[ii])
                | (sh.stderr[si] != h.stderr[ii])
                | (sh.reason[si] != h.reason[ii])
            )
            sub_changed = fresh | neq
            # timestamp residual: the sub stores ISO strings, the info
            # heap datetime objects — rendered in bulk (heap_iso_bulk)
            # and compared only where every cheap field already matched
            res = np.nonzero(both & ~neq)[0]
            if res.size:
                svr, ivr = si[res], ii[res]
                ts_neq = (
                    sh.submit[svr] != heap_iso_bulk(h, "submit", ivr)
                ) | (sh.start[svr] != heap_iso_bulk(h, "start", ivr))
                sub_changed[res[ts_neq]] = True
            state_changed = act & (new_state != state)
            cr_mask = act & (
                sub_changed | state_changed | reason_changed | ep_changed
            )
            has_sub = act & (sub_changed | (slen > 0))

            # ---- CR update capture (value copies) ----
            cr_idx = np.nonzero(cr_mask)[0]
            cr_names = [ordered[i] for i in cr_idx.tolist()]
            cr_exp = jc.rv[jr[cr_idx]].astype(np.int64)
            cr_state_new = new_state[cr_idx].astype(np.int8)
            cr_reason_arr = new_reason[cr_idx]
            cr_ep_arr = new_ep[cr_idx]
            cr_before = state[cr_idx].astype(np.int64)
            cr_subflag = sub_changed[cr_idx]
            sub_of_cr = np.cumsum(cr_subflag) - 1  # cr pos -> sub pos
            sub_idx = cr_idx[cr_subflag]
            iiv = ii[sub_idx]
            sub_id = h.id[iiv].astype(np.int64)
            sub_aid = h.array_id[iiv]
            sub_state = h.state[iiv].astype(np.int8)
            sub_exit = h.exit_code[iiv]
            sub_rt = h.run_time[iiv].astype(np.int64)
            sub_out = h.stdout[iiv]
            sub_err = h.stderr[iiv]
            sub_rsn = h.reason[iiv]
            sub_submit = heap_iso_bulk(h, "submit", iiv)
            sub_start = heap_iso_bulk(h, "start", iiv)
            sub_keys = oarr([
                (a if a else str(int(b)),)
                for a, b in zip(sub_aid.tolist(), sub_id.tolist())
            ])

            # ---- worker capture ----
            hs_idx = np.nonzero(has_sub)[0]
            w_names = [worker_name(ordered[i]) for i in hs_idx.tolist()]
            wrows = pt.rows_for(w_names)
            w_has = wrows >= 0
            w1 = ilen[hs_idx] == 1  # a derivable container exists
            # derive container fields for every has-sub row with one info
            k = len(hs_idx)
            c_name = object_full(k, "")
            c_state = object_full(k, "")
            c_exit = np.zeros(k, np.int32)
            c_reason = object_full(k, "")
            d_idx = np.nonzero(w1)[0]
            if d_idx.size:
                div = ii[hs_idx[d_idx]]
                dst = h.state[div].astype(np.int64)
                dids = h.id[div]
                daid = h.array_id[div]
                decs = h.exit_code[div]
                c_name[d_idx] = [
                    f"job-{a if a else str(int(b))}"
                    for a, b in zip(daid.tolist(), dids.tolist())
                ]
                term = dst <= 3
                run = dst == 5
                cs = object_full(int(d_idx.size), "waiting")
                cs[term] = "terminated"
                cs[run] = "running"
                c_state[d_idx] = cs
                snames = _STATUS_NAME_ARR[dst]
                snames[run] = ""
                c_reason[d_idx] = snames
                ce = np.zeros(int(d_idx.size), np.int32)
                for t in np.nonzero(term)[0].tolist():
                    code = 0
                    ec = decs[t]
                    if ec:
                        try:
                            code = int(ec.split(":")[0])
                        except ValueError:
                            code = 0
                    if code == 0 and dst[t] in (1, 2, 3):  # the bad ends
                        code = 1
                    ce[t] = code
                c_exit[d_idx] = ce
            w_phase = pod_phase[hs_idx].astype(np.int8)
            # creates: no worker row yet
            wc_pos = np.nonzero(~w_has)[0]
            wc_names = [w_names[p] for p in wc_pos.tolist()]
            wc_owner = oarr([ordered[hs_idx[p]] for p in wc_pos.tolist()])
            wc_partition = oarr([
                spec_col[jr[hs_idx[p]]].partition for p in wc_pos.tolist()
            ])
            wc_node = srow_node[hs_idx[wc_pos]]
            wc_phase = w_phase[wc_pos]
            wc_hasc = w1[wc_pos]
            wc_cname = c_name[wc_pos]
            wc_cstate = c_state[wc_pos]
            wc_cexit = c_exit[wc_pos]
            wc_creason = c_reason[wc_pos]
            # updates: worker exists and stored container/phase differ
            we_pos = np.nonzero(w_has)[0]
            wr = wrows[we_pos]
            stored_n = pc.clen[wr].astype(np.int64)
            want1 = w1[we_pos]
            same_n = stored_n == want1.astype(np.int64)
            ci0 = np.where(stored_n == 1, pc.cstart[wr], 0)
            fields_same = (
                (ch.cname[ci0] == c_name[we_pos])
                & (ch.cstate[ci0] == c_state[we_pos])
                & (ch.cexit[ci0] == c_exit[we_pos])
                & (ch.creason[ci0] == c_reason[we_pos])
            )
            phase_same = pc.phase[wr] == w_phase[we_pos]
            skip = same_n & (~want1 | fields_same) & phase_same
            wu = we_pos[~skip]
            wu_names = [w_names[p] for p in wu.tolist()]
            wu_owner = [ordered[hs_idx[p]] for p in wu.tolist()]
            wu_exp = pc.rv[wrows[wu]].astype(np.int64)
            wu_phase = w_phase[wu]
            wu_hasc = w1[wu]
            wu_cname = c_name[wu]
            wu_cstate = c_state[wu]
            wu_cexit = c_exit[wu]
            wu_creason = c_reason[wu]

        # ---- commits: creates first, then updates (oracle order) ----
        if sizecar_creates:
            sc_owners = [o for o, _s, _l in sizecar_creates]
            sc_names = [sizecar_name(o) for o in sc_owners]
            with TRACER.span("operator.sweep.build") as bspan:
                bspan.count("pods", len(sizecar_creates))
                built = build_job.wait() if build_job is not None else None
                if built is not None:
                    sc_demand, sc_labels = self._built_sizecar_rows(
                        sizecar_creates, built
                    )
                    _sweep_pool_rows.inc(len(sizecar_creates))
                else:
                    # the serial oracle — also the fallback when the
                    # pool is off/broken or a build chunk failed (the
                    # real exception then surfaces here, in context)
                    sc_demand = [
                        demand_for_spec(o, s)
                        for o, s, _l in sizecar_creates
                    ]
                    sc_labels = []
                    for (_o, _s, jl), dem in zip(sizecar_creates, sc_demand):
                        arr = array_len(dem.array)
                        labels = {
                            "role": PodRole.SIZECAR,
                            "partition": dem.partition,
                            # resource-request labels (pod.go:164-187)
                            "request-cpu": str(dem.total_cpus(arr)),
                            "request-memory-mb": str(dem.total_mem_mb(arr)),
                        }
                        if jl:
                            # policy-bearing labels ride from the CR onto
                            # the sizecar (cf. _build_sizecar, the object
                            # oracle)
                            for key in (_TENANT_LABEL, _CLASS_LABEL):
                                val = jl.get(key)
                                if val:
                                    labels[key] = val
                        sc_labels.append(FrozenDict(labels))
            sc_owner_arr = oarr(sc_owners)
            sc_name_arr = oarr(sc_names)
            sc_label_arr = oarr(sc_labels)
            sc_demand_arr = oarr(sc_demand)
            sc_part_arr = oarr([d.partition for d in sc_demand])

            def sc_builder(rows, sel):
                m = len(sel)
                pc.name[rows] = sc_name_arr[sel]
                pc.uid[rows] = oarr([new_uid() for _ in range(m)])
                pc.labels[rows] = sc_label_arr[sel]
                pc.ann[rows] = object_full(m, _EMPTY_FROZEN_DICT)
                pc.owner[rows] = sc_owner_arr[sel]
                pc.deleted[rows] = False
                pc.role[rows] = object_full(m, PodRole.SIZECAR)
                pc.partition[rows] = sc_part_arr[sel]
                pc.demand[rows] = sc_demand_arr[sel]
                pc.node[rows] = object_full(m, "")
                pc.hint[rows] = object_full(m, ())
                pc.phase[rows] = _POD_PHASE_PENDING
                pc.reason[rows] = object_full(m, "")
                pc.job_ids[rows] = object_full(m, ())
                pc.njobs[rows] = 0
                pc.istart[rows] = 0
                pc.ilen[rows] = 0
                pc.cstart[rows] = 0
                pc.clen[rows] = 0

            results = self.store.create_rows(
                Pod.KIND, sc_names, sc_builder, site="operator.sweep"
            )
            self.events.emit_batch(
                BridgeJob.KIND,
                Reason.POD_CREATED,
                [
                    (owner, f"sizecar pod {nm} created")
                    for nm, owner, rc in zip(
                        sc_names, sc_owners, results.tolist()
                    )
                    if rc > 0
                ],
            )
        if wc_names:
            empty_fd = FrozenDict()
            wc_name_arr = oarr(wc_names)
            # per-partition label interning, vectorized: one
            # _worker_labels call per distinct partition, fanned out
            # through the unique-inverse instead of 90k dict probes
            wc_uparts, wc_inv = np.unique(wc_partition, return_inverse=True)
            wc_label_arr = oarr(
                [self._worker_labels(p) for p in wc_uparts.tolist()]
            )[wc_inv]

            def builder(rows, sel):
                m = len(sel)
                pc.name[rows] = wc_name_arr[sel]
                pc.uid[rows] = oarr([new_uid() for _ in range(m)])
                pc.labels[rows] = wc_label_arr[sel]
                pc.ann[rows] = object_full(m, empty_fd)
                pc.owner[rows] = wc_owner[sel]
                pc.deleted[rows] = False
                pc.role[rows] = object_full(m, PodRole.WORKER)
                pc.partition[rows] = wc_partition[sel]
                pc.demand[rows] = object_full(m, None)
                pc.node[rows] = wc_node[sel]
                pc.hint[rows] = object_full(m, ())
                pc.phase[rows] = wc_phase[sel]
                pc.reason[rows] = object_full(m, "")
                pc.job_ids[rows] = object_full(m, ())
                pc.njobs[rows] = 0
                pc.istart[rows] = 0
                pc.ilen[rows] = 0
                hasc = wc_hasc[sel]
                rows_c = rows[hasc]
                kk = int(rows_c.size)
                if kk:
                    start = ch.alloc(kk)
                    tgt = np.arange(start, start + kk, dtype=np.int64)
                    src = sel[hasc]
                    ch.cname[tgt] = wc_cname[src]
                    ch.cstate[tgt] = wc_cstate[src]
                    ch.cexit[tgt] = wc_cexit[src]
                    ch.creason[tgt] = wc_creason[src]
                    pc.cstart[rows_c] = tgt
                    pc.clen[rows_c] = 1
                rows_n = rows[~hasc]
                pc.cstart[rows_n] = 0
                pc.clen[rows_n] = 0

            self.store.create_rows(
                Pod.KIND, wc_names, builder, site="operator.sweep"
            )
        if cr_names:

            def cr_writer(rws, sel):
                jc.state[rws] = cr_state_new[sel]
                jc.reason[rws] = cr_reason_arr[sel]
                jc.endpoint[rws] = cr_ep_arr[sel]
                m = cr_subflag[sel]
                rows_sub = rws[m]
                if not rows_sub.size:
                    return
                sh.retire(int(jc.slen[rows_sub].sum()))
                kk = int(rows_sub.size)
                start = sh.alloc(kk)
                tgt = np.arange(start, start + kk, dtype=np.int64)
                src = sub_of_cr[sel[m]]
                sh.id[tgt] = sub_id[src]
                sh.array_id[tgt] = sub_aid[src]
                sh.state[tgt] = sub_state[src]
                sh.exit_code[tgt] = sub_exit[src]
                sh.submit[tgt] = sub_submit[src]
                sh.start[tgt] = sub_start[src]
                sh.run_time[tgt] = sub_rt[src]
                sh.stdout[tgt] = sub_out[src]
                sh.stderr[tgt] = sub_err[src]
                sh.reason[tgt] = sub_rsn[src]
                jc.sstart[rows_sub] = tgt
                jc.slen[rows_sub] = 1
                jc.skeys[rows_sub] = sub_keys[src]
                jt.adapter._maybe_compact_subjobs(jt)

            results = self.store.update_rows(
                BridgeJob.KIND, cr_names, cr_exp, cr_writer,
                site="operator.sweep",
            )
            before_l = cr_before.tolist()
            after_l = cr_state_new.tolist()
            ev_groups: dict[tuple[str, bool], list[tuple[str, str]]] = {}
            for p, rc in enumerate(results.tolist()):
                name = cr_names[p]
                if rc <= 0:
                    # racing writer / vanished: the oracle re-reads
                    slow.append(name)
                    continue
                before, after = before_l[p], after_l[p]
                if before == after:
                    continue
                r = _STATE_REASONS.get(STATE_STRS[after])
                if r:
                    ev_groups.setdefault((r, after == _ST_FAILED), []).append(
                        (name,
                         f"state {STATE_STRS[before]} -> {STATE_STRS[after]}")
                    )
                if after in (_ST_SUCCEEDED, _ST_FAILED):
                    slow.append(name)  # just finished: result pass
            for (r, warn), pairs in ev_groups.items():
                self.events.emit_batch(
                    BridgeJob.KIND, r, pairs, warning=warn
                )
        if wu_names:

            def w_writer(rws, sel):
                pc.phase[rws] = wu_phase[sel]
                hasc = wu_hasc[sel]
                ch.retire(int(pc.clen[rws].sum()))
                rows_c = rws[hasc]
                kk = int(rows_c.size)
                if kk:
                    start = ch.alloc(kk)
                    tgt = np.arange(start, start + kk, dtype=np.int64)
                    src = sel[hasc]
                    ch.cname[tgt] = wu_cname[src]
                    ch.cstate[tgt] = wu_cstate[src]
                    ch.cexit[tgt] = wu_cexit[src]
                    ch.creason[tgt] = wu_creason[src]
                    pc.cstart[rows_c] = tgt
                    pc.clen[rows_c] = 1
                rows_n = rws[~hasc]
                pc.cstart[rows_n] = 0
                pc.clen[rows_n] = 0
                pt.adapter._maybe_compact_containers(pt)

            results = self.store.update_rows(
                Pod.KIND, wu_names, wu_exp, w_writer, site="operator.sweep"
            )
            for owner, rc in zip(wu_owner, results.tolist()):
                if rc <= 0:
                    slow.append(owner)
        if obj_fallback:
            # shapes the fast path doesn't model take the object-path
            # sweep — the same oracle the fuzzed equivalence test pins
            slow.extend(self._sweep(span, obj_fallback))
        span.count("owners", len(ordered))
        span.count("creates", len(sizecar_creates) + len(wc_names))
        span.count("updates", len(cr_names) + len(wu_names))
        span.count("slow", len(set(slow)))
        _reconcile_seconds.observe(time.perf_counter() - t0)
        return sorted(set(slow))

    # ---- sizecar (ReconcileSizeCarPods, :296-319) ----

    def _build_sizecar(self, job: BridgeJob) -> Pod:
        demand = demand_for_job(job)
        arr = array_len(demand.array)
        labels = {
            "role": PodRole.SIZECAR,
            "partition": demand.partition,
            # resource-request labels (pod.go:164-187)
            "request-cpu": str(demand.total_cpus(arr)),
            "request-memory-mb": str(demand.total_mem_mb(arr)),
        }
        job_labels = job.meta.labels
        if job_labels:
            # policy-bearing labels ride from the CR onto the sizecar —
            # the scheduler's class/tenant resolution reads the POD
            # (policy/classes.py); jobs without them pay nothing
            for key in (_TENANT_LABEL, _CLASS_LABEL):
                val = job_labels.get(key)
                if val:
                    labels[key] = val
        # fast_new (every field explicit): one sizecar per arrival, 50k
        # deep on a cold-start tick, against freeze-guarded classes.
        # spec/status (and the demand, born frozen in demand_for_job) are
        # pre-frozen and the label/annotation dicts pre-wrapped (ISSUE
        # 14): commit-time freeze used to re-walk ~45 fields per pod —
        # demand's 19 included — which was a third of the 500k arrive
        # storm; now it probes meta's fields and stops.
        return fast_new(
            Pod,
            meta=fast_new(
                Meta,
                name=sizecar_name(job.meta.name),
                uid=new_uid(),
                labels=FrozenDict(labels),
                annotations=_EMPTY_FROZEN_DICT,
                owner=job.meta.name,
                resource_version=0,
                deleted=False,
            ),
            spec=frozen_new(
                PodSpec,
                role=PodRole.SIZECAR,
                partition=demand.partition,
                demand=demand,
                node_name="",
                placement_hint=(),
            ),
            status=frozen_new(
                PodStatus,
                phase=PodPhase.PENDING,
                reason="",
                job_ids=(),
                job_infos=_EMPTY_FROZEN_LIST,
                containers=_EMPTY_FROZEN_LIST,
            ),
        )

    def _reconcile_sizecar(self, job: BridgeJob) -> None:
        name = sizecar_name(job.meta.name)
        if self.store.try_get(Pod.KIND, name) is not None:
            return
        if job.status.subjobs:
            # pod vanished but sub-jobs exist ⇒ Failed (:296-303)
            self._set_state(
                job.meta.name, JobState.FAILED, reason="sizecar pod disappeared"
            )
            return
        pod = self._build_sizecar(job)
        try:
            self.store.create(pod, site="operator.reconcile")
        except AlreadyExists:
            return
        self.events.event(job, Reason.POD_CREATED, f"sizecar pod {name} created")

    # ---- status sync (UpdateSBJStatus, :246-294) ----

    def _cr_replacement(self, job: BridgeJob, pod: Pod) -> BridgeJob | None:
        """Replacement CR mirroring ``pod``'s state, sharing frozen
        spec/meta children — or None when nothing changed, so the
        no-change case (steady-state reconciles) costs zero copies and
        skips the write (no self-feeding watch loop). Shared by the
        single-key reconcile and the batch sweep so they can never
        drift."""
        state = job_state_for_pod_phase(pod.status.phase)
        subjobs = {
            info.key(): SubjobStatus.from_job_info(info)
            for info in pod.status.job_infos
        }
        pod_reason = pod.status.reason
        new_subjobs = job.status.subjobs
        if subjobs and job.status.subjobs != subjobs:
            new_subjobs = subjobs
        new_state = state
        # don't regress a terminal CR state on a stale pod read
        if job.status.state in JobState.TERMINAL:
            new_state = job.status.state
        new_reason = job.status.reason
        if pod_reason and job.status.reason != pod_reason:
            new_reason = pod_reason
        endpoint = job.status.cluster_endpoint
        if self.agent_endpoint and not endpoint:
            endpoint = self.agent_endpoint
        if (
            new_subjobs is job.status.subjobs
            and new_state == job.status.state
            and new_reason == job.status.reason
            and endpoint == job.status.cluster_endpoint
        ):
            return None
        if new_subjobs is not job.status.subjobs:
            # values are born-frozen SubjobStatus rows; wrapping here lets
            # the status be born frozen too (commit walk: one dict probe)
            new_subjobs = FrozenDict(new_subjobs)
        return fast_replace(
            job,
            meta=fast_replace(job.meta),
            status=frozen_replace(
                job.status,
                state=new_state,
                reason=new_reason,
                subjobs=new_subjobs,
                cluster_endpoint=endpoint,
            ),
        )

    def _emit_state_events(self, before: BridgeJob, after: BridgeJob) -> bool:
        """The recorder calls UpdateSBJStatus makes on a state transition.
        Returns True when the job just finished (needs a result pass)."""
        if before.status.state == after.status.state:
            return False
        r = _STATE_REASONS.get(after.status.state)
        if r:
            self.events.event(
                after, r, f"state {before.status.state} -> {after.status.state}",
                warning=after.status.state == JobState.FAILED,
            )
        return after.finished

    def _sync_status(self, job_name: str) -> None:
        pod = self.store.try_get(Pod.KIND, sizecar_name(job_name))
        if pod is None:
            return
        try:
            before = self.store.get(BridgeJob.KIND, job_name)
            after = self.store.replace_update(
                BridgeJob.KIND, job_name,
                lambda j: self._cr_replacement(j, pod),
                site="operator.status",
            )
        except NotFound:
            return
        # a just-finished job with a result request needs another pass
        if self._emit_state_events(before, after):
            self.controller.enqueue(job_name)

    # ---- worker pods (ReconcileWorkerPods, :365-451) ----

    def _build_worker(
        self, job: BridgeJob, sizecar: Pod | None, containers: FrozenList
    ) -> Pod:
        # fast_new/frozen_new (every field explicit): one worker pod per
        # job with sub-jobs — 45k per transition sweep at the headline
        # shape. spec/status are born frozen (their values are scalars or
        # frozen rows), so the create-commit walk stops at meta.
        return fast_new(
            Pod,
            meta=fast_new(
                Meta,
                name=worker_name(job.meta.name),
                uid=new_uid(),
                labels={"role": PodRole.WORKER, "partition": job.spec.partition},
                annotations={},
                owner=job.meta.name,
                resource_version=0,
                deleted=False,
            ),
            spec=frozen_new(
                PodSpec,
                role=PodRole.WORKER,
                partition=job.spec.partition,
                demand=None,
                node_name=sizecar.spec.node_name if sizecar else "",
                placement_hint=(),
            ),
            status=frozen_new(
                PodStatus,
                phase=sizecar.status.phase if sizecar else PodPhase.PENDING,
                reason="",
                job_ids=(),
                job_infos=_EMPTY_FROZEN_LIST,
                containers=containers,
            ),
        )

    @staticmethod
    def _worker_replacement(
        p: Pod, sizecar: Pod | None, containers: list[ContainerStatus]
    ) -> Pod | None:
        phase = sizecar.status.phase if sizecar else p.status.phase
        if p.status.containers == containers and p.status.phase == phase:
            return None
        return fast_replace(
            p,
            meta=fast_replace(p.meta),
            status=frozen_replace(
                p.status,
                containers=containers
                if isinstance(containers, FrozenList)
                else FrozenList(containers),
                phase=phase,
            ),
        )

    def _reconcile_worker(self, job_name: str) -> None:
        job = self.store.try_get(BridgeJob.KIND, job_name)
        if job is None or not job.status.subjobs:
            return
        sizecar = self.store.try_get(Pod.KIND, sizecar_name(job_name))
        containers = FrozenList(
            container_status_for(info)
            for info in (sizecar.status.job_infos if sizecar else ())
        )
        name = worker_name(job_name)
        existing = self.store.try_get(Pod.KIND, name)
        if existing is None:
            try:
                self.store.create(
                    self._build_worker(job, sizecar, containers),
                    site="operator.worker",
                )
            except AlreadyExists:
                pass
            return
        try:
            self.store.replace_update(
                Pod.KIND, name,
                lambda p: self._worker_replacement(p, sizecar, containers),
                site="operator.worker",
            )
        except NotFound:
            pass

    # ---- results (ReconcileSlurmBridgeJobResult, :321-361 + result.go) ----

    def _reconcile_result(self, job: BridgeJob) -> Result | None:
        # fetch for ANY terminal state: a failed job's stdout is exactly what
        # the user wants back (the reference keys only on "finished",
        # slurmbridgejob_controller.go:131-141)
        if not job.spec.result_to or job.status.state not in JobState.TERMINAL:
            return None
        if job.status.fetch_result in (FetchState.SUCCEEDED, FetchState.FAILED):
            return None
        name = fetch_job_name(job.meta.name)
        fetch = self.store.try_get(FetchJob.KIND, name)
        if fetch is None:
            files = [
                FetchFile(
                    remote_path=sub.std_out,
                    local_path=os.path.join(
                        job.spec.result_to, f"{job.meta.name}-{key}.out"
                    ),
                )
                for key, sub in sorted(job.status.subjobs.items())
                if sub.std_out
            ]
            if not files:
                self._set_fetch_state(job.meta.name, FetchState.FAILED,
                                      reason="no stdout paths to fetch")
                return None
            fetch = FetchJob(
                meta=Meta(name=name, owner=job.meta.name),
                files=files,
                agent_endpoint=self.agent_endpoint,
                state=FetchState.PENDING,
            )
            try:
                self.store.create(fetch, site="operator.fetch")
            except AlreadyExists:
                pass
            self._set_fetch_state(job.meta.name, FetchState.PENDING)
            self.events.event(job, Reason.RESULT_FETCH_STARTED,
                              f"fetching {len(files)} file(s)")
            return Result(requeue_after=RESULT_REQUEUE_S)
        # poll the fetch job's state (FetchResultStatus :349-361)
        if fetch.state in (FetchState.SUCCEEDED, FetchState.FAILED):
            self._set_fetch_state(job.meta.name, fetch.state, reason=fetch.reason)
            self.events.event(
                job,
                Reason.RESULT_FETCH_DONE
                if fetch.state == FetchState.SUCCEEDED
                else Reason.RESULT_FETCH_FAILED,
                fetch.reason or "result fetch finished",
                warning=fetch.state == FetchState.FAILED,
            )
            return None
        return Result(requeue_after=RESULT_REQUEUE_S)

    # ---- helpers ----

    def _set_state(self, job_name: str, state: str, *, reason: str = "") -> None:
        def record(job: BridgeJob):
            if job.status.state == state and job.status.reason == reason:
                return False
            job.status.state = state
            job.status.reason = reason

        try:
            self.store.mutate(
                BridgeJob.KIND, job_name, record, site="operator.state"
            )
        except NotFound:
            pass

    def _set_fetch_state(self, job_name: str, state: str, *, reason: str = "") -> None:
        def record(job: BridgeJob):
            if job.status.fetch_result == state:
                return False
            job.status.fetch_result = state
            if reason:
                job.status.reason = reason

        try:
            self.store.mutate(
                BridgeJob.KIND, job_name, record, site="operator.state"
            )
        except NotFound:
            pass
