"""core dataclasses ↔ wire messages.

The reference's equivalents are the hand-written proto mappers in
pkg/slurm-agent/api/slurm.go:369-473; field-by-field equality of these
round-trips is part of the test surface (mirroring
pkg/slurm-agent/api/slurm_test.go:26-103).
"""

from __future__ import annotations

from datetime import datetime, timezone

from slurm_bridge_tpu_torch.core.fastpath import frozen_new
from slurm_bridge_tpu_torch.core.types import (
    UNLIMITED,
    JobDemand,
    JobInfo,
    JobStatus,
    JobStepInfo,
    NodeInfo,
    PartitionInfo,
)
from slurm_bridge_tpu_torch.wire import messages as pb
from slurm_bridge_tpu_torch.wire.coldec import uvarint as _uvarint


def _ts(dt: datetime | None) -> int:
    if dt is None:
        return 0
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return int(dt.timestamp())


def _dt(ts: int) -> datetime | None:
    if ts <= 0:
        return None
    return datetime.fromtimestamp(ts, tz=timezone.utc).replace(tzinfo=None)


def demand_to_submit(demand: JobDemand, submitter_id: str = "") -> pb.SubmitJobRequest:
    return pb.SubmitJobRequest(
        nodelist=list(demand.nodelist),
        script=demand.script,
        partition=demand.partition,
        submitter_id=submitter_id,
        run_as_user=demand.run_as_user or 0,
        run_as_group=demand.run_as_group or 0,
        cpus_per_task=demand.cpus_per_task,
        ntasks=demand.ntasks,
        ntasks_per_node=demand.ntasks_per_node,
        nodes=demand.nodes,
        mem_per_cpu_mb=demand.mem_per_cpu_mb,
        array=demand.array,
        job_name=demand.job_name,
        working_dir=demand.working_dir,
        gres=demand.gres,
        licenses=demand.licenses,
        time_limit_s=demand.time_limit_s,
        priority=demand.priority,
    )


def fill_submit_request(
    m: pb.SubmitJobRequest, demand: JobDemand, submitter_id: str = ""
) -> None:
    """Write a demand straight into a wire ``SubmitJobRequest`` — the
    batched-submit fan-out path (45k requests per cold-start tick): a
    request constructed via kwargs and appended to the repeated field
    pays a full message COPY per entry; ``requests.add()`` + this fill
    does not. Field-for-field identical to :func:`demand_to_submit`
    (held together by a test)."""
    if demand.nodelist:
        m.nodelist.extend(demand.nodelist)
    m.script = demand.script
    m.partition = demand.partition
    m.submitter_id = submitter_id
    m.run_as_user = demand.run_as_user or 0
    m.run_as_group = demand.run_as_group or 0
    m.cpus_per_task = demand.cpus_per_task
    m.ntasks = demand.ntasks
    m.ntasks_per_node = demand.ntasks_per_node
    m.nodes = demand.nodes
    m.mem_per_cpu_mb = demand.mem_per_cpu_mb
    m.array = demand.array
    m.job_name = demand.job_name
    m.working_dir = demand.working_dir
    m.gres = demand.gres
    m.licenses = demand.licenses
    m.time_limit_s = demand.time_limit_s
    m.priority = demand.priority


#: precomputed proto3 tags for SubmitJobRequest (workload.proto:64-82):
#: tag = (field_number << 3) | wire_type, wire type 2 for strings, 0 for
#: the int64 varints. Fields 16+ need a 2-byte tag.
_T_SCRIPT = b"\x0a"          # 1, string
_T_PARTITION = b"\x12"       # 2, string
_T_SUBMITTER = b"\x1a"       # 3, string
_T_RUN_AS_USER = b"\x20"     # 4, int64
_T_RUN_AS_GROUP = b"\x28"    # 5, int64
_T_CPUS_PER_TASK = b"\x30"   # 6, int64
_T_NTASKS = b"\x38"          # 7, int64
_T_NTASKS_PER_NODE = b"\x40"  # 8, int64
_T_NODES = b"\x48"           # 9, int64
_T_MEM_PER_CPU = b"\x50"     # 10, int64
_T_ARRAY = b"\x5a"           # 11, string
_T_JOB_NAME = b"\x62"        # 12, string
_T_WORKING_DIR = b"\x6a"     # 13, string
_T_GRES = b"\x72"            # 14, string
_T_LICENSES = b"\x7a"        # 15, string
_T_TIME_LIMIT = b"\x80\x01"  # 16, int64
_T_PRIORITY = b"\x88\x01"    # 17, int64
_T_NODELIST = b"\x92\x01"    # 18, repeated string
#: SubmitJobsRequest.requests (workload.proto), field 1 length-delimited
_T_REQUESTS = b"\x0a"


def encode_submit_entry(
    script: str,
    partition: str,
    submitter_id: str,
    run_as_user: int,
    run_as_group: int,
    cpus_per_task: int,
    ntasks: int,
    ntasks_per_node: int,
    nodes: int,
    mem_per_cpu_mb: int,
    array: str,
    job_name: str,
    working_dir: str,
    gres: str,
    licenses: str,
    time_limit_s: int,
    priority: int,
    nodelist,
) -> bytes:
    """One serialized ``SubmitJobRequest`` message body built by hand —
    byte-identical to pb2 ``SerializeToString`` (held by the fuzz suite
    in tests/test_colpool_write.py): known fields emit in field-number
    order, proto3 default scalars (0 / "") are omitted, repeated string
    entries always emit (an explicit empty hostname still rides the
    wire). This is the column-driven twin of :func:`fill_submit_request`
    that the colpool write op runs in worker processes — no pb2 message
    graph is ever built off the main interpreter."""
    parts = []
    if script:
        b = script.encode("utf-8")
        parts += (_T_SCRIPT, _uvarint(len(b)), b)
    if partition:
        b = partition.encode("utf-8")
        parts += (_T_PARTITION, _uvarint(len(b)), b)
    if submitter_id:
        b = submitter_id.encode("utf-8")
        parts += (_T_SUBMITTER, _uvarint(len(b)), b)
    if run_as_user:
        parts += (_T_RUN_AS_USER, _uvarint(run_as_user))
    if run_as_group:
        parts += (_T_RUN_AS_GROUP, _uvarint(run_as_group))
    if cpus_per_task:
        parts += (_T_CPUS_PER_TASK, _uvarint(cpus_per_task))
    if ntasks:
        parts += (_T_NTASKS, _uvarint(ntasks))
    if ntasks_per_node:
        parts += (_T_NTASKS_PER_NODE, _uvarint(ntasks_per_node))
    if nodes:
        parts += (_T_NODES, _uvarint(nodes))
    if mem_per_cpu_mb:
        parts += (_T_MEM_PER_CPU, _uvarint(mem_per_cpu_mb))
    if array:
        b = array.encode("utf-8")
        parts += (_T_ARRAY, _uvarint(len(b)), b)
    if job_name:
        b = job_name.encode("utf-8")
        parts += (_T_JOB_NAME, _uvarint(len(b)), b)
    if working_dir:
        b = working_dir.encode("utf-8")
        parts += (_T_WORKING_DIR, _uvarint(len(b)), b)
    if gres:
        b = gres.encode("utf-8")
        parts += (_T_GRES, _uvarint(len(b)), b)
    if licenses:
        b = licenses.encode("utf-8")
        parts += (_T_LICENSES, _uvarint(len(b)), b)
    if time_limit_s:
        parts += (_T_TIME_LIMIT, _uvarint(time_limit_s))
    if priority:
        parts += (_T_PRIORITY, _uvarint(priority))
    for host in nodelist:
        b = host.encode("utf-8")
        parts += (_T_NODELIST, _uvarint(len(b)), b)
    return b"".join(parts)


def encode_submit_request(demand: JobDemand, submitter_id: str = "") -> bytes:
    """One demand as a serialized ``SubmitJobsRequest`` *entry* — the
    field-18-last wire bytes pb2 produces for ``requests.add()`` +
    :func:`fill_submit_request`, wrapped with the repeated-field tag.
    Concatenating these per-demand entries IS the serialized
    ``SubmitJobsRequest``."""
    body = encode_submit_entry(
        demand.script,
        demand.partition,
        submitter_id,
        demand.run_as_user or 0,
        demand.run_as_group or 0,
        demand.cpus_per_task,
        demand.ntasks,
        demand.ntasks_per_node,
        demand.nodes,
        demand.mem_per_cpu_mb,
        demand.array,
        demand.job_name,
        demand.working_dir,
        demand.gres,
        demand.licenses,
        demand.time_limit_s,
        demand.priority,
        demand.nodelist,
    )
    return _T_REQUESTS + _uvarint(len(body)) + body


def submit_to_demand(req: pb.SubmitJobRequest) -> JobDemand:
    return JobDemand(
        partition=req.partition,
        script=req.script,
        job_name=req.job_name,
        run_as_user=req.run_as_user or None,
        run_as_group=req.run_as_group or None,
        array=req.array,
        cpus_per_task=int(req.cpus_per_task) or 1,
        ntasks=int(req.ntasks) or 1,
        ntasks_per_node=int(req.ntasks_per_node),
        nodes=int(req.nodes) or 1,
        working_dir=req.working_dir,
        mem_per_cpu_mb=int(req.mem_per_cpu_mb),
        gres=req.gres,
        licenses=req.licenses,
        time_limit_s=int(req.time_limit_s),
        priority=int(req.priority),
        nodelist=tuple(req.nodelist),
    )


def job_info_to_proto(j: JobInfo) -> pb.JobInfo:
    return pb.JobInfo(
        id=j.id,
        user_id=j.user_id,
        name=j.name,
        exit_code=j.exit_code,
        status=int(j.state),
        submit_time=_ts(j.submit_time),
        start_time=_ts(j.start_time),
        run_time_s=j.run_time_s,
        time_limit_s=j.time_limit_s,
        working_dir=j.working_dir,
        std_out=j.std_out,
        std_err=j.std_err,
        partition=j.partition,
        node_list=j.node_list,
        batch_host=j.batch_host,
        num_nodes=j.num_nodes,
        array_id=j.array_id,
        reason=j.reason,
    )


#: enum-by-wire-value table: JobStatus(n) pays the Enum __call__ protocol
#: (~1 µs) on every decoded row; the dict probe is ~20× cheaper
_STATUS_BY_NUM = {int(s): s for s in JobStatus}


def job_info_from_proto(m: pb.JobInfo) -> JobInfo:
    # frozen_new: this decode runs once per live job per status-mirror
    # tick (45k rows at the headline shape); born-frozen construction
    # skips 18 guarded setattrs AND the 18-field commit-time freeze walk
    state = _STATUS_BY_NUM.get(m.status)
    if state is None:  # out-of-range wire value: keep the loud ValueError
        state = JobStatus(m.status)
    return frozen_new(
        JobInfo,
        id=int(m.id),
        user_id=m.user_id,
        name=m.name,
        exit_code=m.exit_code,
        state=state,
        submit_time=_dt(m.submit_time),
        start_time=_dt(m.start_time),
        run_time_s=int(m.run_time_s),
        time_limit_s=int(m.time_limit_s),
        working_dir=m.working_dir,
        std_out=m.std_out,
        std_err=m.std_err,
        partition=m.partition,
        node_list=m.node_list,
        batch_host=m.batch_host,
        num_nodes=int(m.num_nodes),
        array_id=m.array_id,
        reason=m.reason,
    )


def step_to_proto(s: JobStepInfo) -> pb.JobStepInfo:
    return pb.JobStepInfo(
        id=s.id,
        name=s.name,
        start_time=_ts(s.start_time),
        finish_time=_ts(s.finish_time),
        exit_code=s.exit_code,
        status=int(s.state),
    )


def step_from_proto(m: pb.JobStepInfo) -> JobStepInfo:
    return JobStepInfo(
        id=m.id,
        name=m.name,
        start_time=_dt(m.start_time),
        finish_time=_dt(m.finish_time),
        exit_code=int(m.exit_code),
        state=JobStatus(m.status),
    )


def node_to_proto(n: NodeInfo) -> pb.Node:
    return pb.Node(
        name=n.name,
        cpus=n.cpus,
        alloc_cpus=n.alloc_cpus,
        memory_mb=n.memory_mb,
        alloc_memory_mb=n.alloc_memory_mb,
        gpus=n.gpus,
        alloc_gpus=n.alloc_gpus,
        gpu_type=n.gpu_type,
        features=list(n.features),
        state=n.state,
    )


def node_from_proto(m: pb.Node) -> NodeInfo:
    return NodeInfo(
        name=m.name,
        cpus=int(m.cpus),
        alloc_cpus=int(m.alloc_cpus),
        memory_mb=int(m.memory_mb),
        alloc_memory_mb=int(m.alloc_memory_mb),
        gpus=int(m.gpus),
        alloc_gpus=int(m.alloc_gpus),
        gpu_type=m.gpu_type,
        features=tuple(m.features),
        # proto3 unset == "": an unstated node state means schedulable
        # (symmetric with partition_from_proto's `or "UP"`)
        state=m.state or "IDLE",
    )


def nodes_from_protos(msgs) -> list[NodeInfo]:
    """Batch node decode — one comprehension instead of a call per message
    at each use site; the first stage of the tick pipeline
    (docs/tick-pipeline.md) and what the tick benchmark times as "decode"."""
    return [node_from_proto(m) for m in msgs]


class NodesDecodeCache:
    """Content-keyed memo for repeated ``Nodes`` responses.

    A steady-state tick re-fetches an inventory that has not moved, and
    re-decoding 10k node protos costs ~120 ms per caller per tick. The
    cache keys on the serialized response bytes — pure content, so ANY
    field change (a drain, an allocation delta, a vanished node) misses
    and decodes fresh — and replays the previously decoded list.
    Single-slot by design: the access pattern is "same response as last
    tick" or "new cluster state", never a working set.

    On a hit the SAME list (and NodeInfo rows) is returned across ticks.
    That is safe — nothing in solver/ or bridge/ mutates NodeInfo — and
    deliberate: the encoder's identity cache keys on node-object
    identity, so a replayed list also skips the inventory re-encode.
    """

    __slots__ = ("_slot", "_bslot")

    def __init__(self):
        # one (resp ref, key, nodes) tuple, swapped atomically — concurrent
        # pool threads may decode the same response twice but never observe
        # a key paired with another response's rows
        self._slot: tuple[object, bytes, list[NodeInfo]] | None = None
        # the bytes-path twin (ISSUE 14): (bytes ref, decoded) — the raw
        # wire buffer IS the content key, so the hit check is one compare
        # (and one identity probe when the sim re-serves cached bytes)
        self._bslot: tuple[bytes, object] | None = None

    def decode_bytes(self, raw: bytes):
        """Decode a raw ``NodesResponse`` wire buffer via the vectorized
        coldec path, content-memoized on the buffer itself. Returns the
        full :class:`~slurm_bridge_tpu_torch.wire.coldec.NodesDecoded` (the
        incremental mirror needs ``version``/``unchanged`` too); on a
        hit the SAME decoded object — and therefore the same identity-
        stable NodeInfo list — is replayed across ticks."""
        from slurm_bridge_tpu_torch.wire import coldec

        slot = self._bslot
        if slot is not None and (slot[0] is raw or slot[0] == raw):
            if slot[0] is not raw:
                self._bslot = (raw, slot[1])
            return slot[1]
        decoded = coldec.decode_nodes(raw)
        if not decoded.unchanged:
            # tiny unchanged=true answers must not evict the full decode
            self._bslot = (raw, decoded)
            # counted HERE, not at the call sites: a memo replay is not
            # a decode, and the counter exists to read decode volume
            coldec.rows_counter().inc(len(decoded.nodes))
        return decoded

    def decode(self, resp) -> list[NodeInfo]:
        slot = self._slot
        if slot is not None and slot[0] is resp:
            # identity fast path (PR-11): an in-process agent (the sim
            # fake, a frozen stale_snapshot window) replays the SAME
            # response object while nothing changed — skip even the
            # O(nodes) serialize the content compare costs. Holding the
            # ref in the slot keeps the id from being recycled.
            return slot[2]
        key = resp.SerializeToString(deterministic=True)
        if slot is not None and slot[1] == key:
            self._slot = (resp, key, slot[2])
            return slot[2]
        nodes = nodes_from_protos(resp.nodes)
        self._slot = (resp, key, nodes)
        return nodes


def partitions_from_protos(msgs) -> list[PartitionInfo]:
    """Batch partition decode (see nodes_from_protos)."""
    return [partition_from_proto(m) for m in msgs]


class PartitionDecodeCache:
    """Identity-keyed memo for repeated ``Partition`` responses (PR-11).

    The sim agent (and a stale_snapshot window) replays the SAME response
    proto while partition membership is unchanged, so the caller can skip
    the O(members) node-tuple rebuild — and, because the decoded
    :class:`PartitionInfo` is also identity-stable, downstream memos
    (cluster-state reuse, shard sub-lists) get an O(1) "nothing moved"
    check. A fresh proto object (the real gRPC path builds one per call)
    decodes fresh — exactly the old behavior."""

    __slots__ = ("_slots",)

    def __init__(self):
        # name → (resp ref, decoded); the ref pin keeps ids stable
        self._slots: dict[str, tuple[object, PartitionInfo]] = {}

    def decode(self, resp) -> PartitionInfo:
        slot = self._slots.get(resp.name)
        if slot is not None and slot[0] is resp:
            return slot[1]
        part = partition_from_proto(resp)
        self._slots[resp.name] = (resp, part)
        return part


def partition_to_proto(p: PartitionInfo) -> pb.PartitionResponse:
    return pb.PartitionResponse(
        name=p.name,
        nodes=list(p.nodes),
        max_time_s=p.max_time_s,
        max_nodes=p.max_nodes,
        max_cpus_per_node=p.max_cpus_per_node,
        max_mem_per_node_mb=p.max_mem_per_node_mb,
        total_cpus=p.total_cpus,
        total_nodes=p.total_nodes,
        state=p.state,
    )


def partition_from_proto(m: pb.PartitionResponse) -> PartitionInfo:
    return PartitionInfo(
        name=m.name,
        nodes=tuple(m.nodes),
        max_time_s=int(m.max_time_s),
        max_nodes=int(m.max_nodes),
        max_cpus_per_node=int(m.max_cpus_per_node),
        max_mem_per_node_mb=int(m.max_mem_per_node_mb),
        total_cpus=int(m.total_cpus),
        total_nodes=int(m.total_nodes),
        state=m.state or "UP",
    )


def demand_to_place(d: JobDemand, *, job_id: str = "") -> pb.PlaceJob:
    """Lower a JobDemand into a PlaceJob for the PlacementSolver sidecar.

    PlaceJob quantities are PER-NODE: the sizecar sizing rule
    (solver/snapshot.py encode_jobs; pkg/slurm-bridge-operator/pod.go:143-162)
    spreads cpu evenly across ``nodes`` shards — sent as the EXACT
    fractional value (the wire fields are doubles) so a sidecar solve
    places identically to the in-process path; rounding up made a job
    whose cpus don't divide evenly by nodes unschedulable on an
    exactly-full cluster only when the sidecar was enabled (ADVICE r3).
    gres is a per-node quantity in Slurm and is not divided; the gres
    *type* rides along as a required feature the solver matches against
    node features.
    """
    from slurm_bridge_tpu_torch.core.arrays import array_len

    arr = array_len(d.array)
    nshards = max(1, d.nodes)
    cpu = d.total_cpus(arr) / nshards
    mem_per_cpu = d.mem_per_cpu_mb or 1024
    gres_parts = d.gres.split(":") if d.gres else []
    gpus = 0
    features: list[str] = []
    if gres_parts and gres_parts[0] == "gpu":
        try:
            gpus = int(gres_parts[-1].split("(")[0]) * max(1, arr)
        except ValueError:
            gpus = 0
    # the gres TYPE is a feature constraint for ANY 3-part gres (tpu:v4:8
    # as much as gpu:a100:2) — mirroring _required_features
    # (solver/snapshot.py); only the count column is gpu-specific
    if len(gres_parts) == 3:
        features.append(gres_parts[1])
    return pb.PlaceJob(
        id=job_id,
        cpus=cpu,
        mem_mb=cpu * mem_per_cpu,
        gpus=gpus,
        partition=d.partition,
        req_features=features,
        nodes=nshards,
        priority=float(d.priority),
    )


def auction_config_to_proto(cfg) -> pb.SolverConfig:
    """AuctionConfig → SolverConfig so a bridge's tuned knobs ride each
    Place RPC instead of being silently replaced by the sidecar's
    launch-time defaults (ADVICE r3)."""
    return pb.SolverConfig(
        rounds=cfg.rounds,
        eta=cfg.eta,
        jitter=cfg.jitter,
        gang_salvage_rounds=cfg.gang_salvage_rounds,
        gang_first=cfg.gang_first,
        affinity_weight=cfg.affinity_weight,
    )


def auction_config_from_proto(msg: pb.SolverConfig, base=None):
    """SolverConfig → AuctionConfig by OVERLAYING the six wire fields onto
    ``base`` (the sidecar's launch-time config): knobs that don't ride the
    wire — candidates, dtype, use_pallas — keep the solver-side tuning
    instead of resetting to dataclass defaults."""
    import dataclasses

    from slurm_bridge_tpu_torch.solver.auction import AuctionConfig

    return dataclasses.replace(
        base or AuctionConfig(),
        rounds=int(msg.rounds),
        eta=float(msg.eta),
        jitter=float(msg.jitter),
        gang_salvage_rounds=int(msg.gang_salvage_rounds),
        gang_first=bool(msg.gang_first),
        affinity_weight=float(msg.affinity_weight),
    )
