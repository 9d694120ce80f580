"""Plain message classes for the RPCs one placement tick exchanges.

The JAX package speaks to the workload agent in protobuf over gRPC
(``wire/workload.proto``). The card's machine has neither ``protobuf``
nor ``grpc`` installed, and the in-process tick needs neither: its client
is an object in the same process. So the port carries these dataclasses,
with the same names and fields as the proto messages, for exactly what
the tick sends and receives. The gRPC transport comes with the slice that
ports the agent connection.

Repeated fields are lists and scalars default to proto3's zero values, so
code written against the generated classes reads the same here.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PartitionsRequest:
    pass


@dataclass
class PartitionsResponse:
    partitions: list[str] = field(default_factory=list)


@dataclass
class PartitionRequest:
    partition: str = ""


@dataclass
class PartitionResponse:
    name: str = ""
    nodes: list[str] = field(default_factory=list)
    max_time_s: int = 0
    max_nodes: int = 0
    max_cpus_per_node: int = 0
    max_mem_per_node_mb: int = 0
    total_cpus: int = 0
    total_nodes: int = 0
    state: str = ""


@dataclass
class NodesRequest:
    names: list[str] = field(default_factory=list)
    #: the ``version`` of the last full NodesResponse this caller applied;
    #: 0 asks for a full response
    since_version: int = 0


@dataclass
class Node:
    name: str = ""
    cpus: int = 0
    alloc_cpus: int = 0
    memory_mb: int = 0
    alloc_memory_mb: int = 0
    gpus: int = 0
    alloc_gpus: int = 0
    gpu_type: str = ""
    features: list[str] = field(default_factory=list)
    state: str = ""

    def content_key(self) -> tuple:
        return (
            self.name, self.cpus, self.alloc_cpus, self.memory_mb,
            self.alloc_memory_mb, self.gpus, self.alloc_gpus, self.gpu_type,
            tuple(self.features), self.state,
        )


@dataclass
class NodesResponse:
    nodes: list[Node] = field(default_factory=list)
    #: the agent's nodes-state version (the next ``since_version``)
    version: int = 0
    #: True iff the caller's cursor matched: ``nodes`` is empty and the
    #: caller's previously decoded inventory is still exact
    unchanged: bool = False

    def content_key(self) -> tuple:
        """A value equal for two responses exactly when every field is
        equal — what the serialized bytes are to a proto message. A
        snapshot: later edits to this response do not change a key
        already taken."""
        return (
            tuple(n.content_key() for n in self.nodes),
            self.version,
            self.unchanged,
        )


@dataclass
class CancelJobRequest:
    job_id: int = 0


@dataclass
class CancelJobResponse:
    pass
