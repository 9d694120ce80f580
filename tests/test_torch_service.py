"""The port's placement-solver sidecar against the JAX package's, and
where the two differ.

The same ``PlaceRequest`` bytes — chip_smoke.py's ``place_request`` over
``random_inventory``'s lists — go through both packages' servicers in
process with the dense auction pinned (the port on the CPU): the
serialized responses are equal, ``free_after`` included, and so are they
after a node is drained, which the port solves on its cached session. A
Place that names the multi-device sweep, or auto-routes to it on two or
more devices, solves on it (eight CPU blocks here) and answers the JAX
package's bytes. ``SolverInfo`` reports the torch backend, its device
count and the sweep's grid; ``--distributed`` joins a process group. ``PlacementScheduler(solver_endpoint=)`` ticks through the port's
sidecar as the JAX package's ticks through its own.
"""

from __future__ import annotations

import logging

import pytest
import torch

import chip_smoke
import slurm_bridge_tpu.solver.auction as jax_auction
import slurm_bridge_tpu.solver.service as jax_service
import slurm_bridge_tpu.wire as jax_wire
import slurm_bridge_tpu_torch.parallel.distributed as port_distributed
import slurm_bridge_tpu_torch.parallel.mesh as port_mesh
import slurm_bridge_tpu_torch.solver.auction as port_auction
import slurm_bridge_tpu_torch.solver.routing as port_routing
import slurm_bridge_tpu_torch.solver.service as port_service
import slurm_bridge_tpu_torch.wire as port_wire
from slurm_bridge_tpu_torch.solver.snapshot import random_inventory
from slurm_bridge_tpu_torch.wire import convert
from slurm_bridge_tpu_torch.wire.rpc import LocalContext

INVENTORY = dict(seed=42, load=0.7, gpu_fraction=0.15, gang_fraction=0.05)


def _dense(auction):
    return auction.AuctionConfig(rounds=8, candidates=0, use_pallas=False)


def _request(nodes=300, jobs=1200, solver="auction"):
    """The port's PlaceRequest bytes for a typed inventory."""
    partitions, node_list, demands = random_inventory(nodes, jobs, **INVENTORY)
    return chip_smoke.place_request(
        port_wire.pb, convert, partitions, node_list, demands, solver=solver
    ).SerializeToString()


def _servicers():
    return (
        jax_service.PlacementSolverServicer(_dense(jax_auction)),
        port_service.PlacementSolverServicer(_dense(port_auction), device="cpu"),
    )


def test_place_equals_the_jax_package_and_reuses_the_session_after_a_drain():
    raw = _request()
    jax_sv, port_sv = _servicers()
    jax_req = jax_wire.pb.PlaceRequest.FromString(raw)
    port_req = port_wire.pb.PlaceRequest.FromString(raw)
    want = jax_sv.Place(jax_req, None)
    got = port_sv.Place(port_req, LocalContext())
    assert got.solver == want.solver == "auction"
    assert chip_smoke.place_digest(got) == chip_smoke.place_digest(want)
    assert chip_smoke.response_digest(port_wire.pb, got) == \
        chip_smoke.response_digest(jax_wire.pb, want)
    session = next(iter(port_sv._sessions.values()))

    drained = chip_smoke.busiest_node(got)
    assert drained == chip_smoke.busiest_node(want)
    want2 = jax_sv.Place(chip_smoke.drained_request(jax_wire.pb, jax_req, drained), None)
    got2 = port_sv.Place(chip_smoke.drained_request(port_wire.pb, port_req, drained),
                         LocalContext())
    assert chip_smoke.response_digest(port_wire.pb, got2) == \
        chip_smoke.response_digest(jax_wire.pb, want2)
    assert not any(drained in a.node_names for a in got2.assignments)
    assert list(port_sv._sessions.values()) == [session]  # update_snapshot, no rebuild
    assert chip_smoke.place_digest(got2) != chip_smoke.place_digest(got)


def _cpu_blocks(monkeypatch, count):
    cpu = torch.device("cpu")
    monkeypatch.setattr(port_mesh, "process_devices", lambda backend: [cpu] * count)


def _jax_sharded_place(raw):
    jax_sv, _ = _servicers()
    return jax_sv.Place(jax_wire.pb.PlaceRequest.FromString(raw), None)


def test_sharded_place_is_unimplemented_and_never_falls_back(monkeypatch):
    """``solver="sharded"`` solves on the multi-device sweep — eight CPU
    blocks, the JAX package's eight virtual devices — with no session
    built, and answers the JAX package's response bytes."""
    _cpu_blocks(monkeypatch, 8)
    _, port_sv = _servicers()
    raw = _request(50, 100, solver="sharded")
    got = port_sv.Place(port_wire.pb.PlaceRequest.FromString(raw), LocalContext())
    want = _jax_sharded_place(raw)
    assert got.solver == want.solver == "sharded" and got.placed > 0
    assert chip_smoke.response_digest(port_wire.pb, got) == \
        chip_smoke.response_digest(jax_wire.pb, want)
    assert port_sv._sessions == {}


def test_auto_route_to_the_sweep_on_two_cards_is_unimplemented(monkeypatch):
    """With two devices and a solve past the sweep's floor, the device
    family's auto route picks the sweep (a dp2×mp1 grid, which places as
    the JAX package's dp4×mp2 does); SolverInfo reports the grid."""
    _cpu_blocks(monkeypatch, 2)
    real = port_routing.use_sharded
    monkeypatch.setattr(port_routing, "use_sharded",
                        lambda p, n, d, threshold=1: real(p, n, d, threshold))
    servicer = port_service.PlacementSolverServicer(_dense(port_auction), device="cpu")
    raw = _request(50, 100, solver="")
    got = servicer.Place(port_wire.pb.PlaceRequest.FromString(raw), LocalContext())
    assert got.solver == "sharded" and servicer._sessions == {}
    assert chip_smoke.place_digest(got) == chip_smoke.place_digest(
        _jax_sharded_place(_request(50, 100, solver="sharded")))
    info = servicer.SolverInfo(port_wire.pb.SolverInfoRequest(), LocalContext())
    assert (info.backend, info.devices, info.mesh) == ("cpu", 2, "dp=2,mp=1")


def test_solver_info_reports_the_torch_backend(monkeypatch):
    servicer = port_service.PlacementSolverServicer(device="cpu")
    info = servicer.SolverInfo(port_wire.pb.SolverInfoRequest(), LocalContext())
    assert (info.backend, info.devices, info.mesh) == ("cpu", 1, "")
    assert list(info.solvers) == list(port_service.SOLVERS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    info = port_service.PlacementSolverServicer().SolverInfo(
        port_wire.pb.SolverInfoRequest(), LocalContext()
    )
    assert (info.backend, info.devices, info.mesh) == ("cuda", 1, "")


def test_solver_info_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    from slurm_bridge_tpu_torch.parallel.backend import BackendUnavailable

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    monkeypatch.delenv("SBT_BACKEND", raising=False)
    with pytest.raises(BackendUnavailable):
        port_service.PlacementSolverServicer().SolverInfo(
            port_wire.pb.SolverInfoRequest(), LocalContext()
        )


def test_distributed_flag_is_refused(monkeypatch):
    """``--distributed`` joins the process group through
    ``init_distributed`` before the sidecar serves (stopped here at the
    join)."""
    joined = []

    def join(*a, **k):
        joined.append((a, k))
        raise SystemExit(7)

    monkeypatch.setattr(port_distributed, "init_distributed", join)
    with pytest.raises(SystemExit) as ei:
        port_service.main(["--distributed", "--listen", "unused.sock"])
    assert ei.value.code == 7 and joined == [((), {})]


def _remote_tick(pkg, sock, wire, service, auction, scheduler_mod, objects, store_cls,
                 inventory, **kw):
    partitions, nodes, demands = inventory
    server = service.serve_solver(sock, _dense(auction), **kw)
    try:
        client = chip_smoke.InventoryClient(wire.pb, wire.convert, partitions, nodes)
        store = chip_smoke.tick_world(objects, store_cls, partitions, demands)
        sched = scheduler_mod.PlacementScheduler(
            store, client, backend="auction", inventory_ttl=0, solver_endpoint=sock,
            auction_config=_dense(auction),
            **({"device": "cpu"} if pkg == "port" else {}),
        )
        try:
            placed = [sched.tick(), sched.tick()]
            digest = chip_smoke.tick_digest(store.list(objects.Pod.KIND))
            return placed, digest, sched.last_route
        finally:
            sched._remote.close()
    finally:
        server.stop(None)


def test_scheduler_ticks_through_the_sidecar_like_the_jax_package(tmp_path):
    import slurm_bridge_tpu.bridge.objects as jax_objects
    import slurm_bridge_tpu.bridge.scheduler as jax_scheduler
    import slurm_bridge_tpu.bridge.store as jax_store
    import slurm_bridge_tpu.solver.snapshot as jax_snapshot
    import slurm_bridge_tpu_torch.bridge.objects as port_objects
    import slurm_bridge_tpu_torch.bridge.scheduler as port_scheduler
    import slurm_bridge_tpu_torch.bridge.store as port_store

    logging.getLogger("sbt").setLevel(logging.ERROR)
    shape = dict(INVENTORY, seed=7)
    want = _remote_tick(
        "jax", str(tmp_path / "jax.sock"), jax_wire, jax_service, jax_auction,
        jax_scheduler, jax_objects, jax_store.ObjectStore,
        jax_snapshot.random_inventory(120, 500, **shape),
    )
    got = _remote_tick(
        "port", str(tmp_path / "port.sock"), port_wire, port_service, port_auction,
        port_scheduler, port_objects, port_store.ObjectStore,
        random_inventory(120, 500, **shape), device="cpu",
    )
    assert got == want
    assert got[2] == "remote-auction" and got[0][0] > 0


def test_scheduler_skips_the_tick_when_the_sidecar_is_down(tmp_path):
    """No sidecar listening: the remote Place fails with the port's
    RpcError, the tick binds nothing, and nothing is solved in process."""
    import slurm_bridge_tpu_torch.bridge.objects as port_objects
    from slurm_bridge_tpu_torch.bridge.scheduler import PlacementScheduler
    from slurm_bridge_tpu_torch.bridge.store import ObjectStore

    partitions, nodes, demands = random_inventory(40, 100, **INVENTORY)
    client = chip_smoke.InventoryClient(port_wire.pb, convert, partitions, nodes)
    store = chip_smoke.tick_world(port_objects, ObjectStore, partitions, demands)
    sched = PlacementScheduler(
        store, client, backend="auction", inventory_ttl=0, device="cpu",
        solver_endpoint=str(tmp_path / "nobody.sock"), place_timeout=2.0,
    )
    try:
        assert sched.tick() == 0
        assert sched._solver is None
        assert not any(p.spec.node_name for p in store.list(port_objects.Pod.KIND))
    finally:
        sched._remote.close()
