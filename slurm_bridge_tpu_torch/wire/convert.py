"""core dataclasses ↔ wire messages, for what the placement tick reads.

The subset of the JAX package's ``wire/convert.py`` the tick uses: node
and partition conversion and the two decode memos, over the port's plain
messages (:mod:`~slurm_bridge_tpu_torch.wire.messages`). The submit,
job-info and solver-config converters come with the slices that need them.
"""

from __future__ import annotations

from slurm_bridge_tpu_torch.core.types import NodeInfo, PartitionInfo
from slurm_bridge_tpu_torch.wire import messages as pb


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
    at each use site."""
    return [node_from_proto(m) for m in msgs]


class NodesDecodeCache:
    """Content-keyed memo for repeated ``Nodes`` responses.

    A steady-state tick re-fetches an inventory that has not moved, so
    the cache keys on the response's content (:meth:`NodesResponse.content_key`,
    which changes with any field, as a proto's serialized bytes do) and
    replays the previously decoded list. Single-slot by design: the access
    pattern is "same response as last tick" or "new cluster state".

    On a hit the SAME list (and NodeInfo rows) is returned across ticks:
    the encoder's identity cache keys on node-object identity, so a
    replayed list also skips the inventory re-encode.
    """

    __slots__ = ("_slot",)

    def __init__(self):
        # one (resp ref, key, nodes) tuple, swapped atomically
        self._slot: tuple[object, tuple, list[NodeInfo]] | None = None

    def decode(self, resp: pb.NodesResponse) -> list[NodeInfo]:
        slot = self._slot
        if slot is not None and slot[0] is resp:
            # identity fast path: an in-process agent replays the SAME
            # response object while nothing changed — skip even the
            # O(nodes) key build. Holding the ref keeps the id unique.
            return slot[2]
        key = resp.content_key()
        if slot is not None and slot[1] == key:
            self._slot = (resp, key, slot[2])
            return slot[2]
        nodes = nodes_from_protos(resp.nodes)
        self._slot = (resp, key, nodes)
        return nodes


class PartitionDecodeCache:
    """Identity-keyed memo for repeated ``Partition`` responses: an agent
    that replays the SAME response object while membership is unchanged
    gets the same decoded :class:`PartitionInfo` back, so downstream memos
    get an O(1) "nothing moved" check. A fresh response decodes fresh."""

    __slots__ = ("_slots",)

    def __init__(self):
        # name → (resp ref, decoded); the ref pin keeps ids stable
        self._slots: dict[str, tuple[object, PartitionInfo]] = {}

    def decode(self, resp: pb.PartitionResponse) -> PartitionInfo:
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
