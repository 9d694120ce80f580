"""What the bridge exchanges with the workload agent.

``pb`` holds the WorkloadManager and PlacementSolver messages named as in
the JAX package's ``workload.proto`` (:mod:`~slurm_bridge_tpu_torch.wire.messages`),
encoded by the port's own proto3 codec (:mod:`~slurm_bridge_tpu_torch.wire.codec`)
byte for byte as ``workload_pb2`` encodes them, and :class:`RpcError` is
the failure a call raises. Neither needs protobuf or grpc. A client is
any object with the RPC methods the caller dials (:class:`ServiceClient`);
the simulator's in-process agent is one. The gRPC transport (``dial``,
a channel-backed client, ``serve``) comes with a later slice.
"""

from __future__ import annotations

from typing import Protocol

from slurm_bridge_tpu_torch.wire import messages as pb
from slurm_bridge_tpu_torch.wire.errors import RpcError, StatusCode


class ServiceClient(Protocol):
    """The agent RPCs the bridge calls. Each takes one request message
    and an optional ``timeout`` in seconds, and raises :class:`RpcError`
    when the call fails. A client may also offer the raw-bytes twins of
    the bulk RPCs (``JobsInfoBytes``, ``NodesBytes``, ``SubmitJobsBytes``),
    which answer the serialized response."""

    def Partitions(self, request: pb.PartitionsRequest, timeout=None) -> pb.PartitionsResponse: ...

    def Partition(self, request: pb.PartitionRequest, timeout=None) -> pb.PartitionResponse: ...

    def Nodes(self, request: pb.NodesRequest, timeout=None) -> pb.NodesResponse: ...

    def CancelJob(self, request: pb.CancelJobRequest, timeout=None) -> pb.CancelJobResponse: ...

    def SubmitJobs(self, request: pb.SubmitJobsRequest, timeout=None) -> pb.SubmitJobsResponse: ...

    def JobsInfo(self, request: pb.JobsInfoRequest, timeout=None) -> pb.JobsInfoResponse: ...


__all__ = ["RpcError", "ServiceClient", "StatusCode", "pb"]
