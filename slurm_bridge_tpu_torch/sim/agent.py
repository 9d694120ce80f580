"""In-process fake Slurm agent — the simulator's ground-truth cluster.

Duck-types the ``WorkloadManager`` :class:`ServiceClient` surface the
bridge dials (Partitions/Partition/Nodes/SubmitJob/JobInfo/JobState/
CancelJob), so the REAL bridge components — configurator, virtual-node
providers, placement scheduler — run unmodified against it with zero
gRPC or subprocess cost. Behind the client sits :class:`SimCluster`, a
deterministic model of Slurm's side of the contract:

- submission allocates immediately when the requested node set fits
  (honouring ``--nodelist`` hints, falling back to first-fit over the
  partition), otherwise the job queues PENDING — exactly the lag the
  statusmap translation layer has to ride out;
- jobs run for ``time_limit_s`` *virtual* seconds (the trace generator
  stamps each job's duration there) and complete when the harness
  advances the clock past their end time — no wall-clock sleeps anywhere;
- allocation is guarded: a start that would oversubscribe any node's
  capacity raises, so the "capacity never oversubscribed" invariant is
  enforced by ground truth, not just sampled;
- the submit ledger dedupes by ``submitter_id`` like the real agent
  (``agent/server.py``), keeping retried submissions idempotent under
  injected RPC faults.

Time is a ``clock()`` callable supplied by the harness (virtual seconds
since scenario start); determinism needs no patching of ``time``.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field

from slurm_bridge_tpu_torch.core.arrays import array_len
from slurm_bridge_tpu_torch.core.fastpath import frozen_new
from slurm_bridge_tpu_torch.core.scontrol import parse_gres_gpus
from slurm_bridge_tpu_torch.core.types import JobInfo, JobStatus, NodeInfo, PartitionInfo
from slurm_bridge_tpu_torch.wire import pb
from slurm_bridge_tpu_torch.wire.coldec import uvarint
from slurm_bridge_tpu_torch.wire.convert import (
    job_info_to_proto,
    node_to_proto,
    partition_to_proto,
)

log = logging.getLogger("sbt.sim.agent")


class OversubscribedError(AssertionError):
    """A job start would exceed a node's capacity — ground-truth invariant
    breach (the scheduler or the sim's own fit check mis-accounted)."""


@dataclass
class SimNode:
    """One simulated Slurm node: static capacity + live allocation."""

    name: str
    cpus: int
    memory_mb: int
    gpus: int = 0
    gpu_type: str = ""
    features: tuple[str, ...] = ()
    #: pre-existing (non-sim-job) allocation, as random_inventory models it
    base_alloc_cpus: int = 0
    base_alloc_memory_mb: int = 0
    state: str = "IDLE"
    #: live allocation from sim jobs
    job_cpus: int = 0
    job_memory_mb: int = 0
    job_gpus: int = 0
    #: (sig, serialized Node message) — the NodesBytes per-node cache;
    #: rebuilt only when the mutable slice (allocation, state) moves.
    #: Pure memo, excluded from comparison/repr.
    wire_cache: tuple | None = field(default=None, repr=False, compare=False)

    @property
    def alloc_cpus(self) -> int:
        return self.base_alloc_cpus + self.job_cpus

    @property
    def alloc_memory_mb(self) -> int:
        return self.base_alloc_memory_mb + self.job_memory_mb

    def info(self) -> NodeInfo:
        state = self.state
        if state in ("IDLE", "MIXED") and not self.drained:
            state = "MIXED" if (self.alloc_cpus or self.job_gpus) else "IDLE"
        return NodeInfo(
            name=self.name,
            cpus=self.cpus,
            alloc_cpus=min(self.cpus, self.alloc_cpus),
            memory_mb=self.memory_mb,
            alloc_memory_mb=min(self.memory_mb, self.alloc_memory_mb),
            gpus=self.gpus,
            alloc_gpus=min(self.gpus, self.job_gpus),
            gpu_type=self.gpu_type,
            features=self.features,
            state=state,
        )

    @property
    def drained(self) -> bool:
        return "DRAIN" in self.state or "DOWN" in self.state

    def wire_bytes(self) -> bytes:
        """This node's serialized ``Node`` message (length-prefixed as a
        ``NodesResponse.nodes`` entry), cached against the mutable slice
        — the serialize-from-ground-truth half of the ISSUE 14 bytes
        path. Decodes identically to ``node_to_proto(self.info())``."""
        sig = (self.state, self.job_cpus, self.job_memory_mb, self.job_gpus)
        c = self.wire_cache
        if c is not None and c[0] == sig:
            return c[1]
        info = self.info()
        out = bytearray()
        nb = info.name.encode()
        out += b"\x0a" + uvarint(len(nb)) + nb
        for tag, v in (
            (b"\x10", info.cpus), (b"\x18", info.alloc_cpus),
            (b"\x20", info.memory_mb), (b"\x28", info.alloc_memory_mb),
            (b"\x30", info.gpus), (b"\x38", info.alloc_gpus),
        ):
            if v:
                out += tag + uvarint(v)
        if info.gpu_type:
            gb = info.gpu_type.encode()
            out += b"\x42" + uvarint(len(gb)) + gb
        for f in info.features:
            fb = f.encode()
            out += b"\x4a" + uvarint(len(fb)) + fb
        if info.state:
            sb = info.state.encode()
            out += b"\x52" + uvarint(len(sb)) + sb
        wrapped = b"\x0a" + uvarint(len(out)) + bytes(out)
        self.wire_cache = (sig, wrapped)
        return wrapped


@dataclass
class SimJob:
    """One submitted job — per-node quantities, gang-expanded over
    ``num_nodes`` distinct nodes (Slurm ``--nodes`` semantics)."""

    id: int
    name: str
    submitter_id: str
    partition: str
    num_nodes: int
    cpus_per_node: int
    mem_per_node_mb: int
    gpus_per_node: int
    duration_s: float
    priority: int
    nodelist: tuple[str, ...] = ()
    state: JobStatus = JobStatus.PENDING
    submit_vt: float = 0.0
    start_vt: float = -1.0
    end_vt: float = -1.0
    assigned: tuple[str, ...] = ()
    reason: str = ""
    #: (entry, info_msg, signature) — the JobsInfo response cache; see
    #: SimAgent.JobsInfo. Excluded from comparison/repr: pure memo.
    pb_cache: tuple | None = field(default=None, repr=False, compare=False)
    #: (sig, entry head, info pre, info post) — the JobsInfoBytes wire
    #: cache: the serialized entry split around the always-ticking
    #: ``run_time_s`` field (number 8), so a call splices the fresh
    #: runtime varint between cached halves instead of re-serializing
    #: 12 fields. Pure memo, excluded from comparison/repr.
    wire_cache: tuple | None = field(default=None, repr=False, compare=False)
    #: last journaled mutable-state signature — keeps journal records
    #: proportional to actual transitions, not queue length (a failed
    #: start re-checks every pending job every step). Pure memo.
    journal_sig: tuple | None = field(default=None, repr=False, compare=False)
    #: jobs-state version at this job's last mutable-state change — the
    #: per-job half of the ``JobsInfo`` cursor contract (PR-11): a
    #: request carrying ``since_version >= version`` may omit this job.
    version: int = field(default=0, repr=False, compare=False)
    #: last signature the version counter saw. Pure memo.
    sync_sig: tuple | None = field(default=None, repr=False, compare=False)

    def _run_time(self, now: float | None) -> int:
        # elapsed runtime like Slurm's RunTime: virtual now, capped at the
        # job's end — NOT the planned duration (a job 1 s into a 120 s run
        # must not already read as at its limit)
        if self.start_vt < 0:
            return 0
        if now is None:
            return int(max(0.0, self.end_vt - self.start_vt))
        return int(max(0.0, min(now, self.end_vt) - self.start_vt))

    def fill_info_proto(self, m: pb.JobInfo, now: float | None = None) -> None:
        """Write this job's state straight into a wire ``JobInfo`` — the
        batched-status fan-out path (45k rows per mirror tick at the
        headline shape), skipping the intermediate dataclass AND the
        proto copy an entry constructed via kwargs would pay. Field-for-
        field identical to ``job_info_to_proto(self.info(now))`` (the
        unary path keeps that form; a test holds the two together)."""
        m.id = self.id
        m.name = self.name
        m.status = int(self.state)
        m.run_time_s = self._run_time(now)
        m.time_limit_s = int(self.duration_s)
        m.partition = self.partition
        m.node_list = ",".join(self.assigned)
        m.batch_host = self.assigned[0] if self.assigned else ""
        m.num_nodes = self.num_nodes
        out = f"/sim/{self.id}.out"
        m.std_out = out
        m.std_err = out
        m.reason = self.reason

    def _wire_parts(self) -> tuple[bytes, bytes, bytes]:
        """(entry head, info-before-run_time, info-after-run_time) —
        field-ordered proto3 encoding of exactly what
        :meth:`fill_info_proto` writes, defaults omitted. Held to the
        pb2 serialization by a decode-parity test."""
        pre = bytearray()
        pre += b"\x08" + uvarint(self.id)  # JobInfo.id (1)
        nb = self.name.encode()
        if nb:
            pre += b"\x1a" + uvarint(len(nb)) + nb  # name (3)
        st = int(self.state)
        if st:
            pre += b"\x28" + uvarint(st)  # status (5)
        post = bytearray()
        tl = int(self.duration_s)
        if tl:
            post += b"\x48" + uvarint(tl)  # time_limit_s (9)
        ob = f"/sim/{self.id}.out".encode()
        olp = uvarint(len(ob)) + ob
        post += b"\x5a" + olp + b"\x62" + olp  # std_out (11) / std_err (12)
        if self.partition:
            p = self.partition.encode()
            post += b"\x6a" + uvarint(len(p)) + p  # partition (13)
        if self.assigned:
            nl = ",".join(self.assigned).encode()
            post += b"\x72" + uvarint(len(nl)) + nl  # node_list (14)
            bh = self.assigned[0].encode()
            post += b"\x7a" + uvarint(len(bh)) + bh  # batch_host (15)
        if self.num_nodes:
            post += b"\x80\x01" + uvarint(self.num_nodes)  # num_nodes (16)
        if self.reason:
            r = self.reason.encode()
            post += b"\x92\x01" + uvarint(len(r)) + r  # reason (18)
        head = b"\x08" + uvarint(self.id) + b"\x10\x01"  # job_id + found
        return head, bytes(pre), bytes(post)

    def entry_bytes(self, now: float | None) -> bytes:
        """One serialized, length-prefixed ``JobsInfoEntry`` for this job
        with the current run time spliced in — the JobsInfoBytes row."""
        sig = (self.state, self.assigned, self.reason)
        c = self.wire_cache
        if c is None or c[0] != sig:
            c = (sig, *self._wire_parts())
            self.wire_cache = c
        _, head, pre, post = c
        rt = self._run_time(now)
        mid = (b"\x40" + uvarint(rt)) if rt else b""  # run_time_s (8)
        info = pre + mid + post
        body = head + b"\x1a" + uvarint(len(info)) + info
        return b"\x0a" + uvarint(len(body)) + body

    def info(self, now: float | None = None) -> JobInfo:
        run_time = self._run_time(now)
        # frozen_new (every field explicit): built once per live job per
        # status query — skipping the guarded __init__ and the freeze walk
        out = f"/sim/{self.id}.out"
        return frozen_new(
            JobInfo,
            id=self.id,
            user_id="",
            name=self.name,
            exit_code="",
            state=self.state,
            submit_time=None,
            start_time=None,
            run_time_s=run_time,
            time_limit_s=int(self.duration_s),
            working_dir="",
            std_out=out,
            std_err=out,
            partition=self.partition,
            node_list=",".join(self.assigned),
            batch_host=self.assigned[0] if self.assigned else "",
            num_nodes=self.num_nodes,
            array_id="",
            reason=self.reason,
        )


@dataclass
class SimStats:
    submitted: int = 0
    deduped: int = 0
    started: int = 0
    completed: int = 0
    cancelled: int = 0

    def as_dict(self) -> dict:
        return {
            "submitted": self.submitted,
            "deduped": self.deduped,
            "started": self.started,
            "completed": self.completed,
            "cancelled": self.cancelled,
        }


class SimCluster:
    """Deterministic ground-truth Slurm: nodes, partitions, job lifecycle.

    Every mutation happens either in an RPC handler (submit/cancel) or in
    :meth:`step` — both driven synchronously by the harness, so identical
    call sequences yield identical state (no threads, no wall clock).
    """

    def __init__(
        self,
        nodes: list[SimNode],
        partitions: dict[str, tuple[str, ...]],
        *,
        clock,
        default_duration_s: float = 30.0,
    ):
        self.nodes: dict[str, SimNode] = {n.name: n for n in nodes}
        self.partitions = dict(partitions)
        self.hidden: set[str] = set()
        self.jobs: dict[int, SimJob] = {}
        self.clock = clock
        self.default_duration_s = default_duration_s
        self.stats = SimStats()
        self._ledger: dict[str, int] = {}
        self._next_id = 1000
        self._queue: list[int] = []  # PENDING job ids, submit order
        #: jobs-state version (PR-11): bumped on every job mutable-state
        #: transition (submit/start/complete/cancel/reason change) — the
        #: ``JobsInfo`` cursor an incremental mirror hands back so an
        #: idle tick's status query returns no rows. Starts at 1 so a
        #: first response already carries a usable cursor (0 on the wire
        #: means "no cursor support").
        self.state_version = 1
        #: nodes-state version: bumped on any allocation/drain change —
        #: the ``Nodes`` cursor that turns an idle inventory fetch into
        #: one tiny unchanged=true round-trip.
        self.nodes_version = 1
        #: the agent job-state journal (PR-8): when attached, every
        #: ledger entry and job lifecycle transition is appended durably,
        #: and :meth:`crash_reload` rebuilds the whole agent-process
        #: state from replay — the ``agent_crash`` fault's recovery path
        self.journal = None

    # ---- agent job-state journal (PR-8) ----

    def attach_journal(self, journal) -> None:
        """Start journaling — and rebase the journal around the current
        (usually empty) state so a previous incarnation's tail can never
        mix with this process's records."""
        self.journal = journal
        ledger, jobs = self.journal_state()
        journal.checkpoint(ledger, jobs)

    @staticmethod
    def _job_doc(job: SimJob) -> dict:
        """Full journal document for one job — every field
        :meth:`crash_reload` needs to reconstruct the ``SimJob`` exactly
        (the sim journal carries complete state because ``SimCluster``
        plays both the login-node daemon AND Slurm; the real agent's
        journal carries identity only — Slurm holds its job state)."""
        return {
            "id": job.id,
            "name": job.name,
            "submitter_id": job.submitter_id,
            "partition": job.partition,
            "num_nodes": job.num_nodes,
            "cpus_per_node": job.cpus_per_node,
            "mem_per_node_mb": job.mem_per_node_mb,
            "gpus_per_node": job.gpus_per_node,
            "duration_s": job.duration_s,
            "priority": job.priority,
            "nodelist": list(job.nodelist),
            "state": int(job.state),
            "submit_vt": job.submit_vt,
            "start_vt": job.start_vt,
            "end_vt": job.end_vt,
            "assigned": list(job.assigned),
            "reason": job.reason,
        }

    @staticmethod
    def _job_from_doc(doc: dict) -> SimJob:
        return SimJob(
            id=int(doc["id"]),
            name=doc["name"],
            submitter_id=doc["submitter_id"],
            partition=doc["partition"],
            num_nodes=int(doc["num_nodes"]),
            cpus_per_node=int(doc["cpus_per_node"]),
            mem_per_node_mb=int(doc["mem_per_node_mb"]),
            gpus_per_node=int(doc["gpus_per_node"]),
            duration_s=float(doc["duration_s"]),
            priority=int(doc["priority"]),
            nodelist=tuple(doc["nodelist"]),
            state=JobStatus(int(doc["state"])),
            submit_vt=float(doc["submit_vt"]),
            start_vt=float(doc["start_vt"]),
            end_vt=float(doc["end_vt"]),
            assigned=tuple(doc["assigned"]),
            reason=doc["reason"],
        )

    @staticmethod
    def _mut_sig(job: SimJob) -> tuple:
        """The mutable slice of a job the journal doc captures."""
        return (
            int(job.state), job.assigned, job.reason,
            job.start_vt, job.end_vt,
        )

    def _touch(self, job: SimJob) -> None:
        """Advance the jobs-state version iff this job's mirror-visible
        state (state machine, assignment, reason — the ``pb_cache``
        signature) actually moved. Called at every transition site, so
        ``job.version`` is exactly the cursor the JobsInfo contract
        promises: unchanged jobs sit at or below any applied cursor."""
        sig = (job.state, job.assigned, job.reason)
        if job.sync_sig == sig:
            return
        job.sync_sig = sig
        self.state_version += 1
        job.version = self.state_version

    def _journal_job(self, job: SimJob) -> None:
        if self.journal is None:
            return
        sig = self._mut_sig(job)
        if job.journal_sig == sig:
            return  # nothing the doc captures has moved
        job.journal_sig = sig
        self.journal.record_job(job.id, self._job_doc(job))

    def journal_state(self) -> tuple[dict[str, int], dict[int, dict]]:
        """(ledger, job docs) for a journal checkpoint."""
        return dict(self._ledger), {
            jid: self._job_doc(j) for jid, j in sorted(self.jobs.items())
        }

    def crash_reload(self) -> int:
        """The ``agent_crash`` fault: drop every piece of agent-process
        state — jobs, ledger, queue, per-node allocations — and rebuild
        it from journal replay, in place (the client wrapper keeps its
        reference). Node hardware state (drained flags, base allocation)
        and hidden partitions are cluster-side truth and survive; so does
        :attr:`stats`, which is the simulator's measurement layer, not
        agent state. Returns the number of jobs restored; a lossless
        replay leaves the cluster byte-identical to the moment of the
        crash — the ``final_state_digest`` twin gate proves exactly that.
        """
        if self.journal is None:
            raise RuntimeError("agent_crash without an attached journal")
        state = self.journal.load()
        self.jobs.clear()
        self._ledger = dict(state.ledger)
        self._queue = []
        for node in self.nodes.values():
            node.job_cpus = 0
            node.job_memory_mb = 0
            node.job_gpus = 0
        for jid in sorted(state.jobs):
            job = self._job_from_doc(state.jobs[jid])
            self.jobs[job.id] = job
            if job.state == JobStatus.RUNNING:
                for name in job.assigned:
                    node = self.nodes.get(name)
                    if node is None:
                        continue
                    node.job_cpus += job.cpus_per_node
                    node.job_memory_mb += job.mem_per_node_mb
                    node.job_gpus += job.gpus_per_node
            elif job.state == JobStatus.PENDING:
                self._queue.append(job.id)  # ids are submit-ordered
        self._next_id = max(self.jobs, default=self._next_id - 1) + 1
        # cursor hygiene: every caller-held cursor predates this reload's
        # rebuilt state, so every job must read as "changed" — one shared
        # bump past every outstanding cursor does it (versions only need
        # to EXCEED cursors, not be distinct per job). Node state was
        # rebuilt too, so the inventory cursor moves with it.
        self.state_version += 1
        for job in self.jobs.values():
            job.version = self.state_version
            job.sync_sig = (job.state, job.assigned, job.reason)
        self.nodes_version += 1
        # rebase: fold the replayed state into a fresh snapshot under the
        # new incarnation (mirrors Bridge.start()'s compact-first)
        ledger, jobs = self.journal_state()
        self.journal.checkpoint(ledger, jobs)
        return len(self.jobs)

    # ---- inventory ----

    def visible_partitions(self) -> list[str]:
        return [p for p in self.partitions if p not in self.hidden]

    def partition_info(self, name: str) -> PartitionInfo:
        members = self.partitions[name]
        total_cpus = sum(self.nodes[m].cpus for m in members)
        return PartitionInfo(
            name=name,
            nodes=tuple(members),
            total_cpus=total_cpus,
            total_nodes=len(members),
        )

    def node_infos(self, names: list[str]) -> list[NodeInfo]:
        return [self.nodes[n].info() for n in names if n in self.nodes]

    # ---- fault-plan surface (mutated by the harness, not by RPCs) ----

    def drain(self, names: list[str]) -> None:
        for n in names:
            node = self.nodes.get(n)
            if node is not None and not node.drained:
                node.state = "DRAINED"
                self.nodes_version += 1

    def resume(self, names: list[str]) -> None:
        for n in names:
            node = self.nodes.get(n)
            if node is not None and node.drained:
                node.state = "IDLE"
                self.nodes_version += 1

    def hide_partition(self, name: str) -> None:
        self.hidden.add(name)

    def show_partition(self, name: str) -> None:
        self.hidden.discard(name)

    # ---- job lifecycle ----

    def submit(self, req: pb.SubmitJobRequest) -> int:
        submitter = req.submitter_id
        if submitter and submitter in self._ledger:
            self.stats.deduped += 1
            return self._ledger[submitter]
        arr = array_len(req.array) if req.array else 1
        total_cpus = (
            max(1, int(req.cpus_per_task)) * max(1, int(req.ntasks)) * max(1, arr)
        )
        nnodes = max(1, int(req.nodes))
        cpus_per_node = math.ceil(total_cpus / nnodes)
        mem_per_node = math.ceil(int(req.mem_per_cpu_mb) * total_cpus / nnodes)
        gpus_per_node, _ = parse_gres_gpus(req.gres) if req.gres else (0, "")
        job = SimJob(
            id=self._next_id,
            name=req.job_name or f"job-{self._next_id}",
            submitter_id=submitter,
            partition=req.partition,
            num_nodes=nnodes,
            cpus_per_node=cpus_per_node,
            mem_per_node_mb=mem_per_node,
            gpus_per_node=gpus_per_node * max(1, arr),
            duration_s=float(req.time_limit_s) or self.default_duration_s,
            priority=int(req.priority),
            nodelist=tuple(req.nodelist),
            submit_vt=self.clock(),
        )
        self._next_id += 1
        self.jobs[job.id] = job
        if submitter:
            self._ledger[submitter] = job.id
        self.stats.submitted += 1
        started = self._try_start(job)
        if not started:
            self._queue.append(job.id)
        self._touch(job)
        if self.journal is not None:
            # ledger + post-placement job state behind ONE durability
            # barrier (the dedupe token is what a crashed agent must
            # never lose)
            job.journal_sig = self._mut_sig(job)
            self.journal.record_submit(submitter, job.id, self._job_doc(job))
        return job.id

    def cancel(self, job_id: int) -> None:
        job = self.jobs.get(job_id)
        if job is None or job.state.is_terminal:
            return  # scancel of an unknown/finished job is a no-op
        if job.state == JobStatus.RUNNING:
            self._free(job)
        job.state = JobStatus.CANCELLED
        job.end_vt = self.clock()
        self.stats.cancelled += 1
        self._touch(job)
        self._journal_job(job)

    def step(self) -> None:
        """Advance the cluster to the current virtual time: complete jobs
        whose runtime elapsed, then start queued jobs that now fit."""
        now = self.clock()
        for job in self.jobs.values():
            if job.state == JobStatus.RUNNING and job.end_vt <= now:
                self._free(job)
                job.state = JobStatus.COMPLETED
                self.stats.completed += 1
                self._touch(job)
                self._journal_job(job)
        still: list[int] = []
        for jid in self._queue:
            job = self.jobs[jid]
            if job.state != JobStatus.PENDING:
                continue  # cancelled while queued
            if not self._try_start(job):
                still.append(jid)
            # journal BOTH outcomes: a failed start still rewrites the
            # job's ``reason`` (Resources / partition unavailable), and a
            # crash replaying the stale reason would diverge from the
            # crash-free twin when agent_crash composes with
            # drain/vanish windows
            self._touch(job)
            self._journal_job(job)
        self._queue = still

    def _fits(self, node: SimNode, job: SimJob) -> bool:
        if node.drained:
            return False
        return (
            node.alloc_cpus + job.cpus_per_node <= node.cpus
            and node.alloc_memory_mb + job.mem_per_node_mb <= node.memory_mb
            and node.job_gpus + job.gpus_per_node <= node.gpus
        )

    def _try_start(self, job: SimJob) -> bool:
        if job.partition in self.hidden or job.partition not in self.partitions:
            job.reason = f"partition {job.partition!r} unavailable"
            return False
        chosen: list[str] = []
        # the solver's --nodelist hint first, in hint order; Slurm remains
        # the final arbiter, so an infeasible hint falls back to first-fit
        for name in job.nodelist:
            node = self.nodes.get(name)
            if node is not None and name not in chosen and self._fits(node, job):
                chosen.append(name)
                if len(chosen) == job.num_nodes:
                    break
        if len(chosen) < job.num_nodes:
            for name in self.partitions[job.partition]:
                if name in chosen:
                    continue
                if self._fits(self.nodes[name], job):
                    chosen.append(name)
                    if len(chosen) == job.num_nodes:
                        break
        if len(chosen) < job.num_nodes:
            job.reason = "Resources"
            return False
        self.nodes_version += 1
        for name in chosen:
            node = self.nodes[name]
            node.job_cpus += job.cpus_per_node
            node.job_memory_mb += job.mem_per_node_mb
            node.job_gpus += job.gpus_per_node
            if (
                node.alloc_cpus > node.cpus
                or node.alloc_memory_mb > node.memory_mb
                or node.job_gpus > node.gpus
            ):
                raise OversubscribedError(
                    f"node {name} oversubscribed by job {job.id}"
                )
        job.assigned = tuple(chosen)
        job.state = JobStatus.RUNNING
        job.start_vt = self.clock()
        job.end_vt = job.start_vt + job.duration_s
        job.reason = ""
        self.stats.started += 1
        return True

    def _free(self, job: SimJob) -> None:
        self.nodes_version += 1
        for name in job.assigned:
            node = self.nodes.get(name)
            if node is None:
                continue
            node.job_cpus -= job.cpus_per_node
            node.job_memory_mb -= job.mem_per_node_mb
            node.job_gpus -= job.gpus_per_node

    # ---- introspection for invariants/metrics ----

    def running_jobs(self) -> list[SimJob]:
        return [j for j in self.jobs.values() if j.state == JobStatus.RUNNING]

    def pending_jobs(self) -> list[SimJob]:
        return [j for j in self.jobs.values() if j.state == JobStatus.PENDING]


class SimWorkloadClient:
    """The ``WorkloadManager`` client surface over a :class:`SimCluster`.

    Method-for-method compatible with the dynamic :class:`ServiceClient`
    stub (``wire/rpc.py``) for every RPC the bridge dials; each method
    accepts the stub's keyword ``timeout`` and ignores it (there is no
    wall-clock in the simulator). Unknown-partition/unknown-file errors
    surface as :class:`SimRpcError` so the bridge's RPC error handling
    runs for real.

    Tracing parity with the real wire: where the gRPC stub would inject
    ``traceparent`` metadata and the agent's server interceptor would open
    an ``rpc.<Method>`` span under it, the in-process fake honors the
    SAME contract through the ambient contextvar (the in-process
    equivalent of the metadata) — each RPC named in ``TRACED_RPCS`` opens
    an agent-side span that parents into the caller's tick trace, so sim
    flight records are end-to-end. Outside an active sampled trace the
    wrapper costs one contextvar read.
    """

    #: RPCs wrapped in agent-side spans (the surface the bridge dials)
    TRACED_RPCS = (
        "Partitions", "Partition", "Nodes", "SubmitJob", "SubmitJobs",
        "CancelJob", "JobInfo", "JobsInfo", "JobState",
    )

    #: raw-bytes twins of the bulk RPCs (ISSUE 14): same logical call —
    #: counted and span-named under the BASE method, so call-count gates
    #: and flight trees read identically whichever form the mirror dials
    BYTES_RPCS = ("JobsInfo", "Nodes", "SubmitJobs")

    def __init__(self, cluster: SimCluster):
        self.cluster = cluster
        #: RPC calls served, per method — the steady-state zero-work gate
        #: reads this (one dict increment per call; the real agent's
        #: Prometheus counters play this role in production)
        self.calls: dict[str, int] = {}
        #: partition responses are immutable at sim scope (membership and
        #: node capacities never change), so each is built once and the
        #: SAME proto object is replayed — identity-stable responses are
        #: what lets caller-side decode memos run at O(1)
        self._part_cache: dict[str, pb.PartitionResponse] = {}
        #: version-keyed whole-response bytes caches, pinned on the
        #: caller's (reused) request proto: an unchanged shard re-serves
        #: the SAME bytes object, so content-keyed decode memos hit on
        #: an identity probe
        self._jobs_bytes_cache: dict[int, tuple] = {}
        self._nodes_bytes_cache: dict[int, tuple] = {}
        from slurm_bridge_tpu_torch.obs.tracing import TRACER, current_span

        calls = self.calls

        def traced(name, fn):
            def call(request, timeout=None):
                calls[name] = calls.get(name, 0) + 1
                parent = current_span()
                if parent is None or not parent.sampled:
                    return fn(request, timeout=timeout)
                with TRACER.span(f"rpc.{name}", agent="sim"):
                    return fn(request, timeout=timeout)

            return call

        for name in self.TRACED_RPCS:
            setattr(self, name, traced(name, getattr(self, name)))
        for name in self.BYTES_RPCS:
            setattr(
                self, name + "Bytes", traced(name, getattr(self, name + "Bytes"))
            )

    def close(self) -> None:  # ServiceClient parity
        pass

    # ---- inventory RPCs ----

    def Partitions(self, request, timeout=None) -> pb.PartitionsResponse:
        return pb.PartitionsResponse(partitions=self.cluster.visible_partitions())

    def Partition(self, request, timeout=None) -> pb.PartitionResponse:
        name = request.partition
        if name in self.cluster.hidden or name not in self.cluster.partitions:
            from slurm_bridge_tpu_torch.sim.faults import SimRpcError
            from slurm_bridge_tpu_torch.wire import StatusCode

            raise SimRpcError(
                StatusCode.NOT_FOUND, f"partition {name!r} not found"
            )
        resp = self._part_cache.get(name)
        if resp is None:
            resp = partition_to_proto(self.cluster.partition_info(name))
            self._part_cache[name] = resp
        return resp

    def Nodes(self, request, timeout=None) -> pb.NodesResponse:
        # the cursor short-circuit (PR-11): a caller whose last applied
        # inventory is still exact gets `unchanged=true` and NO node rows
        # — an idle mirror's fetch skips the O(nodes) proto build AND the
        # caller's decode. since_version=0 (old caller) = full response.
        ver = self.cluster.nodes_version
        if request.since_version and request.since_version == ver:
            return pb.NodesResponse(version=ver, unchanged=True)
        infos = self.cluster.node_infos(list(request.names))
        resp = pb.NodesResponse(nodes=[node_to_proto(n) for n in infos])
        resp.version = ver
        return resp

    # ---- job RPCs ----

    def SubmitJob(self, request, timeout=None) -> pb.SubmitJobResponse:
        return pb.SubmitJobResponse(job_id=self.cluster.submit(request))

    def SubmitJobs(self, request, timeout=None) -> pb.SubmitJobsResponse:
        """Batched submit — agent/server.py parity: one entry per request,
        order preserved, answered from ground truth (SimCluster.submit
        never rejects a script, so every entry is ok; per-item failures
        are the FaultyClient's job)."""
        resp = pb.SubmitJobsResponse()
        add = resp.results.add  # in-place: no per-entry message copy
        for r in request.requests:
            add(job_id=self.cluster.submit(r), ok=True)
        return resp

    def CancelJob(self, request, timeout=None) -> pb.CancelJobResponse:
        self.cluster.cancel(int(request.job_id))
        return pb.CancelJobResponse()

    def JobInfo(self, request, timeout=None) -> pb.JobInfoResponse:
        job = self.cluster.jobs.get(int(request.job_id))
        if job is None:
            from slurm_bridge_tpu_torch.sim.faults import SimRpcError
            from slurm_bridge_tpu_torch.wire import StatusCode

            raise SimRpcError(
                StatusCode.NOT_FOUND, f"job {request.job_id} not found"
            )
        return pb.JobInfoResponse(
            info=[job_info_to_proto(job.info(now=self.cluster.clock()))]
        )

    def JobsInfo(self, request, timeout=None) -> pb.JobsInfoResponse:
        """Batched JobInfo — agent/server.py parity: unknown ids come back
        found=false, the batch never aborts on one bad id.

        Each job keeps a cached, pre-filled ``JobsInfoEntry``: a call
        refills it only when the job's mutable state (state machine,
        assignment, reason) moved, patches the always-ticking
        ``run_time_s``, and C-level-copies it into the response
        (``jobs.append`` copies, so no mutable message ever escapes —
        the FaultyClient's lost_status freeze keeps true snapshots).
        Byte-identical to the 18-Python-setattr in-place fill it
        replaces, ~3× cheaper on the steady 45k-row mirror tick."""
        now = self.cluster.clock()
        jobs = self.cluster.jobs
        resp = pb.JobsInfoResponse()
        ver = self.cluster.state_version
        resp.version = ver
        since = request.since_version
        if since and since >= ver:
            # no job anywhere has changed since the caller's cursor: the
            # whole chunk is unchanged — O(1), no id scan at all (unknown
            # ids were already reported found=false when first seen, and
            # an id can't become unknown without a state transition)
            return resp
        add = resp.jobs.add
        append = resp.jobs.append
        for job_id in request.job_ids:
            job = jobs.get(int(job_id))
            if job is None:
                add(job_id=job_id, found=False)
                continue
            if since and job.version <= since:
                continue  # unchanged since the caller's cursor: omitted
            cache = job.pb_cache
            sig = (job.state, job.assigned, job.reason)
            if cache is None or cache[2] != sig:
                e = pb.JobsInfoEntry(job_id=job.id, found=True)
                m = e.info.add()
                job.fill_info_proto(m, now=now)
                job.pb_cache = (e, m, sig)
            else:
                e, m, _ = cache
                m.run_time_s = job._run_time(now)
            append(e)
        return resp

    # ---- the serialize-from-ground-truth bytes paths (ISSUE 14) ----
    #
    # Each is the byte-level twin of its pb RPC above: identical cursor
    # semantics, identical entry order, decoding column-identical to the
    # pb2 path (parity tests in tests/test_coldec.py) — but the response
    # is assembled from per-object serialized caches and splices, so a
    # 45k-row mirror pass builds ZERO protobuf objects on either side.

    def JobsInfoBytes(self, request, timeout=None) -> bytes:
        now = self.cluster.clock()
        jobs = self.cluster.jobs
        ver = self.cluster.state_version
        since = request.since_version
        ver_field = b"\x10" + uvarint(ver)
        if since and since >= ver:
            return ver_field  # whole chunk unchanged: version only
        key = id(request)
        slot = self._jobs_bytes_cache.get(key)
        seen = slot is not None and slot[0] is request
        if seen and len(slot) == 4 and slot[1] == since and slot[2] == ver:
            return slot[3]
        parts = []
        append = parts.append
        for job_id in request.job_ids:
            job = jobs.get(int(job_id))
            if job is None:
                e = b"\x08" + uvarint(job_id)  # found=False omitted
                append(b"\x0a" + uvarint(len(e)) + e)
                continue
            if since and job.version <= since:
                continue  # unchanged since the caller's cursor: omitted
            append(job.entry_bytes(now))
        data = b"".join(parts) + ver_field
        if len(self._jobs_bytes_cache) > 1024:
            self._jobs_bytes_cache.clear()  # dead request pins
        # two-touch caching: the PR-11 incremental mirror REUSES its
        # chunk request protos, so the second sighting of the same
        # object is worth a payload slot; one-shot requests (the cold
        # full path builds fresh protos per sync) only pin a tiny seen
        # marker instead of a full response buffer per miss
        self._jobs_bytes_cache[key] = (
            (request, since, ver, data) if seen else (request,)
        )
        return data

    def NodesBytes(self, request, timeout=None) -> bytes:
        ver = self.cluster.nodes_version
        tail = b"\x10" + uvarint(ver)
        if request.since_version and request.since_version == ver:
            return tail + b"\x18\x01"  # version + unchanged=true
        key = id(request)
        slot = self._nodes_bytes_cache.get(key)
        seen = slot is not None and slot[0] is request
        if seen and len(slot) == 3 and slot[1] == ver:
            return slot[2]
        nodes = self.cluster.nodes
        data = b"".join(
            nodes[n].wire_bytes() for n in request.names if n in nodes
        ) + tail
        if len(self._nodes_bytes_cache) > 1024:
            self._nodes_bytes_cache.clear()
        # two-touch, like the jobs cache: only reused request protos
        # earn a payload slot
        self._nodes_bytes_cache[key] = (
            (request, ver, data) if seen else (request,)
        )
        return data

    def SubmitJobsBytes(self, request, timeout=None) -> bytes:
        if isinstance(request, (bytes, bytearray, memoryview)):
            # the provider's worker-pool pre-encode ships raw wire bytes
            # (ISSUE 18) — a real channel's request serializer passes
            # them through; this in-process seam parses them back, so
            # the submit draws are a pure function of the wire content
            # either way
            request = pb.SubmitJobsRequest.FromString(bytes(request))
        parts = []
        for r in request.requests:
            e = b"\x08" + uvarint(self.cluster.submit(r)) + b"\x10\x01"
            parts.append(b"\x0a" + uvarint(len(e)) + e)
        return b"".join(parts)

    def JobState(self, request, timeout=None) -> pb.JobStateResponse:
        job = self.cluster.jobs.get(int(request.job_id))
        status = int(job.state) if job is not None else int(JobStatus.UNKNOWN)
        return pb.JobStateResponse(status=status)
