"""The fleet's state and wire across the two packages.

The port keeps its own copy of ``workload.proto``'s descriptor bytes
(``wire/schema.py``) for the fleet's version handshake: the bytes equal
the JAX package's — whose tables ``tests/test_torch_wire.py`` holds the
port's messages to — and hash to the same ``schema_digest``; otherwise a
port bridge and a JAX-package sidecar would refuse each other. A ``PlaceShard``
request encodes to the same bytes in both packages, each package decodes
the other's, and the pure per-shard solve answers the same bytes. The
membership file one package writes, the other reads to the same live set
and shard ownership.
"""

from __future__ import annotations

import numpy as np
import pytest

import slurm_bridge_tpu.fleet.columnar as jax_columnar
import slurm_bridge_tpu.fleet.membership as jax_membership
import slurm_bridge_tpu.solver.snapshot as jax_snapshot
import slurm_bridge_tpu_torch.fleet.columnar as port_columnar
import slurm_bridge_tpu_torch.fleet.membership as port_membership
import slurm_bridge_tpu_torch.solver.snapshot as port_snapshot
from slurm_bridge_tpu.wire import workload_pb2
from slurm_bridge_tpu_torch.wire import messages as pb
from slurm_bridge_tpu_torch.wire.schema import SERIALIZED_PB


def test_schema_bytes_and_digest_equal_the_jax_package():
    assert SERIALIZED_PB == workload_pb2.DESCRIPTOR.serialized_pb
    assert pb.DESCRIPTOR.serialized_pb is SERIALIZED_PB
    assert port_columnar.schema_digest() == jax_columnar.schema_digest()
    assert len(port_columnar.schema_digest()) == 16


def test_has_field_follows_protobuf():
    assert not pb.PlaceRequest().HasField("config")
    req = pb.PlaceRequest(config=pb.SolverConfig())
    assert req.HasField("config")
    back = pb.PlaceRequest.FromString(req.SerializeToString())
    assert back.HasField("config") == workload_pb2.PlaceRequest.FromString(
        req.SerializeToString()).HasField("config")
    with pytest.raises(ValueError):
        pb.PlaceRequest().HasField("solver")
    with pytest.raises(ValueError):
        workload_pb2.PlaceRequest().HasField("solver")


def _shapes(seed):
    port = port_snapshot.random_scenario(80, 260, seed=seed, gang_fraction=0.2)
    jax = jax_snapshot.random_scenario(80, 260, seed=seed, gang_fraction=0.2)
    inc = np.where(np.arange(port[1].num_shards) % 4 == 0,
                   np.arange(port[1].num_shards) % 80, -1).astype(np.int32)
    return port, jax, inc


def _untimed(msg_cls, raw) -> bytes:
    r = msg_cls.FromString(raw)
    r.solve_ms = 0.0
    r.decode_ns = r.solve_ns = r.encode_ns = 0
    return r.SerializeToString()


@pytest.mark.parametrize("engine,policy", [("greedy", ""), ("native", ""), ("native", "best")])
@pytest.mark.parametrize("pinned", [False, True])
def test_place_shard_bytes_cross_the_packages(engine, policy, pinned):
    (psnap, pbatch), (jsnap, jbatch), inc = _shapes(5)
    inc = inc if pinned else None
    port_req = port_columnar.encode_place_shard(3, engine, policy, psnap, pbatch, inc)
    jax_req = jax_columnar.encode_place_shard(3, engine, policy, jsnap, jbatch, inc)
    raw = port_req.SerializeToString()
    assert raw == jax_req.SerializeToString()
    # each package decodes the other's request and solves it to the same bytes
    port_resp = port_columnar.solve_place_shard(pb.PlaceShardRequest.FromString(raw))
    jax_resp = jax_columnar.solve_place_shard(workload_pb2.PlaceShardRequest.FromString(raw))
    assert _untimed(pb.PlaceShardResponse, port_resp.SerializeToString()) == \
        _untimed(workload_pb2.PlaceShardResponse, jax_resp.SerializeToString())
    placement = port_columnar.placement_from_response(
        pb.PlaceShardResponse.FromString(jax_resp.SerializeToString()),
        pbatch.num_shards, psnap.num_nodes,
    )
    assert placement.placed.any()
    if pinned:
        kept = placement.placed & (inc >= 0)
        assert (placement.node_of[kept] == inc[kept]).all()


@pytest.mark.parametrize("writer,reader", [
    (port_membership, jax_membership), (jax_membership, port_membership),
])
def test_membership_file_is_read_by_the_other_package(tmp_path, writer, reader):
    clock = [100.0]
    path = str(tmp_path / "membership.json")
    table = writer.MembershipTable(path, lease_duration=10.0, clock=lambda: clock[0])
    for i in range(3):
        table.join(f"replica-{i}", f"replica-{i}.1", f"/s/replica-{i}.sock")
    table.mark_dead("replica-1", reason="process exited")
    clock[0] += 5.0
    table.renew("replica-0")
    table._flush()
    again = reader.MembershipTable(path, lease_duration=10.0, clock=lambda: clock[0])
    assert again.replicas == table.replicas
    assert again.live() == table.live() == ["replica-0", "replica-2"]
    assert again.rekey_count == table.rekey_count
    assert again.shard_sets(7) == table.shard_sets(7)
    assert [again.owner_of(s) for s in range(7)] == [table.owner_of(s) for s in range(7)]
    clock[0] += 9.0  # replica-2's lease lapses, replica-0's does not
    assert again.expire() == ["replica-2"]
    with open(path + ".wal", encoding="utf-8") as fh:
        events = [line for line in fh if line.strip()]
    assert any('"expire"' in e for e in events)
