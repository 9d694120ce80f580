"""What the placement tick exchanges with the workload agent.

``pb`` holds plain message classes named as in the JAX package's
``workload.proto`` (:mod:`~slurm_bridge_tpu_torch.wire.messages`), and
:class:`RpcError` is the failure the tick catches. Neither needs protobuf
or grpc. A client is any object with the RPC methods the tick calls
(:class:`ServiceClient`); an in-process agent is one.
"""

from __future__ import annotations

from typing import Protocol

from slurm_bridge_tpu_torch.wire import messages as pb
from slurm_bridge_tpu_torch.wire.errors import RpcError, StatusCode


class ServiceClient(Protocol):
    """The agent RPCs a placement tick calls. Each takes one request
    message and an optional ``timeout`` in seconds, and raises
    :class:`RpcError` when the call fails."""

    def Partitions(self, request: pb.PartitionsRequest, timeout=None) -> pb.PartitionsResponse: ...

    def Partition(self, request: pb.PartitionRequest, timeout=None) -> pb.PartitionResponse: ...

    def Nodes(self, request: pb.NodesRequest, timeout=None) -> pb.NodesResponse: ...

    def CancelJob(self, request: pb.CancelJobRequest, timeout=None) -> pb.CancelJobResponse: ...


__all__ = ["RpcError", "ServiceClient", "StatusCode", "pb"]
