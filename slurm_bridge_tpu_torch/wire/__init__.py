"""The WorkloadManager + PlacementSolver contract.

``pb`` holds the messages named as in the JAX package's ``workload.proto``
(:mod:`~slurm_bridge_tpu_torch.wire.messages`), encoded by the port's own
proto3 codec (:mod:`~slurm_bridge_tpu_torch.wire.codec`) byte for byte as
``workload_pb2`` encodes them, and :class:`RpcError` is the failure a call
raises. Neither needs protobuf or grpc. :mod:`rpc` derives the gRPC stubs
and handlers (:class:`ServiceClient`, :func:`dial`, :func:`serve`,
:func:`generic_handler`) from the port's schema and imports ``grpc`` only
when one of them is called, so the in-process tick and the simulator —
whose client is any object with the RPC methods the caller dials — import
this package on a machine without grpc.
"""

from __future__ import annotations

from slurm_bridge_tpu_torch.wire import messages as pb
from slurm_bridge_tpu_torch.wire.errors import RpcError, StatusCode
from slurm_bridge_tpu_torch.wire.rpc import (
    ServiceClient,
    dial,
    generic_handler,
    normalize_endpoint,
    serve,
    service_methods,
)

__all__ = [
    "pb",
    "RpcError",
    "ServiceClient",
    "StatusCode",
    "dial",
    "generic_handler",
    "normalize_endpoint",
    "serve",
    "service_methods",
]
