"""The WorkloadManager and PlacementSolver messages, without protobuf.

The JAX package speaks to the workload agent in protobuf over gRPC
(``wire/workload.proto``, compiled to ``workload_pb2``). The card's
machine has neither ``protobuf`` nor ``grpc``, so the port declares the
same messages here — same names, field names, numbers and types — and
encodes them with its own proto3 codec (:mod:`~slurm_bridge_tpu_torch.wire.codec`),
whose bytes equal ``workload_pb2``'s. Code written against the generated
module reads the same against this one: keyword construction,
``SerializeToString``/``FromString``, repeated fields with ``add`` and
copying ``append``, the enum values as module attributes (``RUNNING``,
``FOLLOW``, …) and a ``DESCRIPTOR`` with the schema (and, as
``serialized_pb``, the ``FileDescriptorProto`` bytes of
:mod:`~slurm_bridge_tpu_torch.wire.schema`).
"""

from __future__ import annotations

from slurm_bridge_tpu_torch.wire.codec import (
    BOOL,
    BYTES,
    DOUBLE,
    ENUM,
    INT32,
    INT64,
    REPEATED,
    STRING,
    FileDescriptor,
    Message,
)
from slurm_bridge_tpu_torch.wire.schema import SERIALIZED_PB

# ---- enums (values as module attributes, as workload_pb2 has them) ----

# JobStatus
COMPLETED = 0
CANCELLED = 1
FAILED = 2
TIMEOUT = 3
PENDING = 4
RUNNING = 5
UNKNOWN = 6

# TailAction
FOLLOW = 0
READ_TO_END_AND_CLOSE = 1

# ---- WorkloadManager ---------------------------------------------------


class SubmitJobRequest(Message):
    FIELDS = (
        ("script", 1, STRING),
        ("partition", 2, STRING),
        ("submitter_id", 3, STRING),
        ("run_as_user", 4, INT64),
        ("run_as_group", 5, INT64),
        ("cpus_per_task", 6, INT64),
        ("ntasks", 7, INT64),
        ("ntasks_per_node", 8, INT64),
        ("nodes", 9, INT64),
        ("mem_per_cpu_mb", 10, INT64),
        ("array", 11, STRING),
        ("job_name", 12, STRING),
        ("working_dir", 13, STRING),
        ("gres", 14, STRING),
        ("licenses", 15, STRING),
        ("time_limit_s", 16, INT64),
        ("priority", 17, INT64),
        ("nodelist", 18, STRING, REPEATED),
    )


class SingularityOptions(Message):
    FIELDS = (
        ("image", 1, STRING),
        ("binds", 2, STRING, REPEATED),
        ("contain", 3, BOOL),
        ("fakeroot", 4, BOOL),
        ("cleanenv", 5, BOOL),
        ("no_home", 6, BOOL),
        ("writable", 7, BOOL),
        ("apps", 8, STRING, REPEATED),
    )


class SubmitJobContainerRequest(Message):
    FIELDS = (
        ("job", 1, "SubmitJobRequest"),
        ("container", 2, "SingularityOptions"),
    )


class SubmitJobResponse(Message):
    FIELDS = (("job_id", 1, INT64),)


class SubmitJobsRequest(Message):
    FIELDS = (("requests", 1, "SubmitJobRequest", REPEATED),)


class SubmitJobsEntry(Message):
    FIELDS = (
        ("job_id", 1, INT64),
        ("ok", 2, BOOL),
        ("error_code", 3, STRING),
        ("error", 4, STRING),
    )


class SubmitJobsResponse(Message):
    FIELDS = (("results", 1, "SubmitJobsEntry", REPEATED),)


class CancelJobRequest(Message):
    FIELDS = (("job_id", 1, INT64),)


class CancelJobResponse(Message):
    FIELDS = ()


class JobInfoRequest(Message):
    FIELDS = (("job_id", 1, INT64),)


class JobInfo(Message):
    FIELDS = (
        ("id", 1, INT64),
        ("user_id", 2, STRING),
        ("name", 3, STRING),
        ("exit_code", 4, STRING),
        ("status", 5, ENUM),
        ("submit_time", 6, INT64),
        ("start_time", 7, INT64),
        ("run_time_s", 8, INT64),
        ("time_limit_s", 9, INT64),
        ("working_dir", 10, STRING),
        ("std_out", 11, STRING),
        ("std_err", 12, STRING),
        ("partition", 13, STRING),
        ("node_list", 14, STRING),
        ("batch_host", 15, STRING),
        ("num_nodes", 16, INT64),
        ("array_id", 17, STRING),
        ("reason", 18, STRING),
    )


class JobInfoResponse(Message):
    FIELDS = (("info", 1, "JobInfo", REPEATED),)


class JobsInfoRequest(Message):
    FIELDS = (
        ("job_ids", 1, INT64, REPEATED),
        ("since_version", 2, INT64),
    )


class JobsInfoEntry(Message):
    FIELDS = (
        ("job_id", 1, INT64),
        ("found", 2, BOOL),
        ("info", 3, "JobInfo", REPEATED),
    )


class JobsInfoResponse(Message):
    FIELDS = (
        ("jobs", 1, "JobsInfoEntry", REPEATED),
        ("version", 2, INT64),
    )


class JobStepsRequest(Message):
    FIELDS = (("job_id", 1, INT64),)


class JobStepInfo(Message):
    FIELDS = (
        ("id", 1, STRING),
        ("name", 2, STRING),
        ("start_time", 3, INT64),
        ("finish_time", 4, INT64),
        ("exit_code", 5, INT32),
        ("status", 6, ENUM),
    )


class JobStepsResponse(Message):
    FIELDS = (("steps", 1, "JobStepInfo", REPEATED),)


class JobStateRequest(Message):
    FIELDS = (("job_id", 1, INT64),)


class JobStateResponse(Message):
    FIELDS = (("status", 1, ENUM),)


class OpenFileRequest(Message):
    FIELDS = (("path", 1, STRING),)


class Chunk(Message):
    FIELDS = (("content", 1, BYTES),)


class TailFileRequest(Message):
    FIELDS = (
        ("path", 1, STRING),
        ("action", 2, ENUM),
    )


class ResourcesRequest(Message):
    FIELDS = (("partition", 1, STRING),)


class ResourcesResponse(Message):
    FIELDS = (
        ("nodes", 1, INT64),
        ("cpu_per_node", 2, INT64),
        ("mem_per_node_mb", 3, INT64),
        ("wall_time_s", 4, INT64),
        ("features", 5, STRING, REPEATED),
    )


class PartitionsRequest(Message):
    FIELDS = ()


class PartitionsResponse(Message):
    FIELDS = (("partitions", 1, STRING, REPEATED),)


class PartitionRequest(Message):
    FIELDS = (("partition", 1, STRING),)


class PartitionResponse(Message):
    FIELDS = (
        ("name", 1, STRING),
        ("nodes", 2, STRING, REPEATED),
        ("max_time_s", 3, INT64),
        ("max_nodes", 4, INT64),
        ("max_cpus_per_node", 5, INT64),
        ("max_mem_per_node_mb", 6, INT64),
        ("total_cpus", 7, INT64),
        ("total_nodes", 8, INT64),
        ("state", 9, STRING),
    )


class NodesRequest(Message):
    FIELDS = (
        ("names", 1, STRING, REPEATED),
        ("since_version", 2, INT64),
    )


class Node(Message):
    FIELDS = (
        ("name", 1, STRING),
        ("cpus", 2, INT64),
        ("alloc_cpus", 3, INT64),
        ("memory_mb", 4, INT64),
        ("alloc_memory_mb", 5, INT64),
        ("gpus", 6, INT64),
        ("alloc_gpus", 7, INT64),
        ("gpu_type", 8, STRING),
        ("features", 9, STRING, REPEATED),
        ("state", 10, STRING),
    )


class NodesResponse(Message):
    FIELDS = (
        ("nodes", 1, "Node", REPEATED),
        ("version", 2, INT64),
        ("unchanged", 3, BOOL),
    )


class WorkloadInfoRequest(Message):
    FIELDS = ()


class WorkloadInfoResponse(Message):
    FIELDS = (
        ("name", 1, STRING),
        ("version", 2, STRING),
        ("uid", 3, STRING),
    )


class HealthzRequest(Message):
    FIELDS = ()


class HealthzResponse(Message):
    FIELDS = (
        ("service", 1, STRING),
        ("incarnation", 2, STRING),
        ("schema_version", 3, STRING),
        ("shard_set", 4, INT64, REPEATED),
        ("pid", 5, INT64),
        ("metric_name", 6, STRING, REPEATED),
        ("metric_total", 7, DOUBLE, REPEATED),
    )


# ---- PlacementSolver ---------------------------------------------------


class PlaceJob(Message):
    FIELDS = (
        ("id", 1, STRING),
        ("cpus", 10, DOUBLE),
        ("mem_mb", 11, DOUBLE),
        ("gpus", 4, INT64),
        ("partition", 5, STRING),
        ("req_features", 6, STRING, REPEATED),
        ("nodes", 7, INT64),
        ("priority", 8, DOUBLE),
        ("incumbent_node_names", 9, STRING, REPEATED),
        ("priority_override", 12, DOUBLE),
        ("has_priority_override", 13, BOOL),
    )


class SolverConfig(Message):
    FIELDS = (
        ("rounds", 1, INT64),
        ("eta", 2, DOUBLE),
        ("jitter", 3, DOUBLE),
        ("gang_salvage_rounds", 4, INT64),
        ("gang_first", 5, BOOL),
        ("affinity_weight", 6, DOUBLE),
    )


class PlaceRequest(Message):
    FIELDS = (
        ("jobs", 1, "PlaceJob", REPEATED),
        ("inventory", 2, "Node", REPEATED),
        ("partitions", 3, "PartitionResponse", REPEATED),
        ("solver", 4, STRING),
        ("config", 5, "SolverConfig"),
    )


class Assignment(Message):
    FIELDS = (
        ("job_id", 1, STRING),
        ("node_names", 2, STRING, REPEATED),
    )


class PlaceResponse(Message):
    FIELDS = (
        ("assignments", 1, "Assignment", REPEATED),
        ("placed", 2, INT64),
        ("total", 3, INT64),
        ("solve_ms", 4, DOUBLE),
        ("solver", 5, STRING),
        ("free_after", 6, DOUBLE, REPEATED),
    )


class SolverInfoRequest(Message):
    FIELDS = ()


class SolverInfoResponse(Message):
    FIELDS = (
        ("backend", 1, STRING),
        ("devices", 2, INT64),
        ("mesh", 3, STRING),
        ("solvers", 4, STRING, REPEATED),
    )


class PlaceShardRequest(Message):
    FIELDS = (
        ("engine", 1, STRING),
        ("policy", 2, STRING),
        ("num_nodes", 3, INT64),
        ("num_rows", 4, INT64),
        ("free", 5, BYTES),
        ("node_partition", 6, BYTES),
        ("node_features", 7, BYTES),
        ("demand", 8, BYTES),
        ("job_partition", 9, BYTES),
        ("req_features", 10, BYTES),
        ("priority", 11, BYTES),
        ("gang_id", 12, BYTES),
        ("job_of", 13, BYTES),
        ("incumbent", 14, BYTES),
        ("shard_id", 15, INT64),
    )


class PlaceShardResponse(Message):
    FIELDS = (
        ("node_of", 1, BYTES),
        ("placed", 2, BYTES),
        ("free_after", 3, BYTES),
        ("engine", 4, STRING),
        ("solve_ms", 5, DOUBLE),
        ("decode_ns", 6, INT64),
        ("solve_ns", 7, INT64),
        ("encode_ns", 8, INT64),
        ("rows", 9, INT64),
    )


#: (service, [(method, request, response, client streaming, server
#: streaming)]) in workload.proto's order
_SERVICES = (
    ("WorkloadManager", [
        ("SubmitJob", "SubmitJobRequest", "SubmitJobResponse", False, False),
        ("SubmitJobs", "SubmitJobsRequest", "SubmitJobsResponse", False, False),
        ("SubmitJobContainer", "SubmitJobContainerRequest", "SubmitJobResponse", False, False),
        ("CancelJob", "CancelJobRequest", "CancelJobResponse", False, False),
        ("JobInfo", "JobInfoRequest", "JobInfoResponse", False, False),
        ("JobsInfo", "JobsInfoRequest", "JobsInfoResponse", False, False),
        ("JobSteps", "JobStepsRequest", "JobStepsResponse", False, False),
        ("JobState", "JobStateRequest", "JobStateResponse", False, False),
        ("OpenFile", "OpenFileRequest", "Chunk", False, True),
        ("TailFile", "TailFileRequest", "Chunk", True, True),
        ("Resources", "ResourcesRequest", "ResourcesResponse", False, False),
        ("Partitions", "PartitionsRequest", "PartitionsResponse", False, False),
        ("Partition", "PartitionRequest", "PartitionResponse", False, False),
        ("Nodes", "NodesRequest", "NodesResponse", False, False),
        ("WorkloadInfo", "WorkloadInfoRequest", "WorkloadInfoResponse", False, False),
        ("Healthz", "HealthzRequest", "HealthzResponse", False, False),
    ]),
    ("PlacementSolver", [
        ("Place", "PlaceRequest", "PlaceResponse", False, False),
        ("SolverInfo", "SolverInfoRequest", "SolverInfoResponse", False, False),
        ("PlaceShard", "PlaceShardRequest", "PlaceShardResponse", False, False),
        ("Healthz", "HealthzRequest", "HealthzResponse", False, False),
    ]),
)

#: the schema: message types (nested fields resolved) and services
DESCRIPTOR = FileDescriptor(
    "sbt.workload",
    [
        v for v in list(globals().values())
        if isinstance(v, type) and issubclass(v, Message) and v is not Message
    ],
    services=_SERVICES,
    serialized_pb=SERIALIZED_PB,
)
