"""The gRPC transport across the two packages, over unix sockets.

A port ``ServiceClient`` calls a JAX-package ``serve``, and a JAX-package
client calls a port ``serve``: ``Place``, ``PlaceShard``, ``Healthz``,
``SolverInfo`` and the raw-bytes ``NodesBytes``. With the engine pinned on
both sides the responses are byte-identical whichever package answers
(the wall-clock timing fields zeroed); failures reach each client as its
own package's error with the server's status code. A fleet worker of
each package is adopted by the other package's ``SidecarSupervisor``: the
two hash one schema. Every server is stopped and every worker killed in a
``finally``.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import grpc
import pytest

import chip_smoke
import slurm_bridge_tpu.fleet.columnar as jax_columnar
import slurm_bridge_tpu.fleet.sidecar as jax_sidecar
import slurm_bridge_tpu.solver.auction as jax_auction
import slurm_bridge_tpu.solver.service as jax_service
import slurm_bridge_tpu.wire as jax_wire
import slurm_bridge_tpu.wire.rpc as jax_rpc
import slurm_bridge_tpu_torch.fleet.columnar as port_columnar
import slurm_bridge_tpu_torch.fleet.sidecar as port_sidecar
import slurm_bridge_tpu_torch.solver.auction as port_auction
import slurm_bridge_tpu_torch.solver.service as port_service
import slurm_bridge_tpu_torch.wire as port_wire
import slurm_bridge_tpu_torch.wire.rpc as port_rpc
from slurm_bridge_tpu_torch.obs.tracing import TRACER, InMemoryExporter
from slurm_bridge_tpu_torch.solver.snapshot import random_inventory, random_scenario
from slurm_bridge_tpu_torch.wire import RpcError, StatusCode

REPO = pathlib.Path(__file__).resolve().parents[1]


def _nodes_response(pb):
    return pb.NodesResponse(
        nodes=[pb.Node(name=f"n{i}", cpus=8 + i, alloc_cpus=i, memory_mb=4096,
                       features=["a", "b"][: i % 3], state="IDLE") for i in range(5)],
        version=7,
    )


class _Nodes:
    """A WorkloadManager servicer answering ``Nodes`` in ``pb``'s messages."""

    def __init__(self, pb):
        self.pb = pb

    def Nodes(self, request, context):
        return _nodes_response(self.pb)


def _dense(auction):
    return auction.AuctionConfig(rounds=8, candidates=0, use_pallas=False)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """One server per package, each hosting its PlacementSolver (dense
    auction; the port's on the CPU) and a WorkloadManager with ``Nodes``."""
    d = tmp_path_factory.mktemp("rpc")
    jax_sock, port_sock = str(d / "jax.sock"), str(d / "port.sock")
    started = []
    try:
        started.append(jax_rpc.serve({
            "PlacementSolver": jax_service.PlacementSolverServicer(_dense(jax_auction)),
            "WorkloadManager": _Nodes(jax_wire.pb),
        }, jax_sock))
        started.append(port_rpc.serve({
            "PlacementSolver": port_service.PlacementSolverServicer(
                _dense(port_auction), device="cpu"),
            "WorkloadManager": _Nodes(port_wire.pb),
        }, port_sock))
        yield jax_sock, port_sock
    finally:
        for server in started:
            server.stop(None)


@pytest.fixture(scope="module")
def clients(servers):
    """Every (client package, server package) pair's PlacementSolver and
    WorkloadManager clients."""
    jax_sock, port_sock = servers
    made = {}
    try:
        for cpkg, rpc in (("jax", jax_rpc), ("port", port_rpc)):
            for spkg, sock in (("jax", jax_sock), ("port", port_sock)):
                made[cpkg, spkg] = (
                    rpc.ServiceClient(rpc.dial(sock), "PlacementSolver", retry=None),
                    rpc.ServiceClient(rpc.dial(sock), "WorkloadManager", retry=None),
                )
        yield made
    finally:
        for solver, workload in made.values():
            solver.close()
            workload.close()


_PB = {"jax": jax_wire.pb, "port": port_wire.pb}


def _place_bytes(solver="auction"):
    partitions, nodes, demands = random_inventory(
        150, 600, seed=42, load=0.7, gpu_fraction=0.15, gang_fraction=0.05
    )
    return chip_smoke.place_request(
        port_wire.pb, port_wire.convert, partitions, nodes, demands, solver=solver
    ).SerializeToString()


@pytest.mark.parametrize("solver", ["auction", "greedy", "indexed", "sharded"])
def test_place_bytes_are_identical_across_the_packages(clients, solver):
    """Each engine, the multi-device sweep included (the JAX server's on its
    eight virtual devices, the port server's on its one CPU device: the
    sweep's placement does not depend on the grid)."""
    raw = _place_bytes(solver)
    got = {}
    for (cpkg, spkg), (client, _) in clients.items():
        pb = _PB[cpkg]
        resp = client.Place(pb.PlaceRequest.FromString(raw), timeout=60)
        assert resp.solver == solver
        got[cpkg, spkg] = chip_smoke.response_digest(pb, resp)
    assert len(set(got.values())) == 1, got


def _place_shard_bytes():
    snap, batch = random_scenario(60, 200, seed=3)
    return port_columnar.encode_place_shard(
        4, "greedy", "", snap, batch, None
    ).SerializeToString()


def _untimed(pb, resp) -> bytes:
    r = pb.PlaceShardResponse.FromString(resp.SerializeToString())
    r.solve_ms = 0.0
    r.decode_ns = r.solve_ns = r.encode_ns = 0
    return r.SerializeToString()


def test_place_shard_bytes_are_identical_across_the_packages(clients):
    raw = _place_shard_bytes()
    got = {
        key: _untimed(_PB[key[0]], client.PlaceShard(
            _PB[key[0]].PlaceShardRequest.FromString(raw), timeout=60))
        for key, (client, _) in clients.items()
    }
    assert len(set(got.values())) == 1
    rows = port_wire.pb.PlaceShardRequest.FromString(raw).num_rows
    assert port_wire.pb.PlaceShardResponse.FromString(got["port", "jax"]).rows == rows > 0


def test_healthz_and_solver_info_across_the_packages(clients):
    for (cpkg, spkg), (client, _) in clients.items():
        pb = _PB[cpkg]
        hz = client.Healthz(pb.HealthzRequest(), timeout=10)
        assert hz.service == "solver" and hz.pid == os.getpid()
        assert hz.schema_version == port_columnar.schema_digest() \
            == jax_columnar.schema_digest()
        info = client.SolverInfo(pb.SolverInfoRequest(), timeout=10)
        assert info.backend == "cpu"
        assert list(info.solvers) == ["auction", "greedy", "sharded", "indexed"]
        # one card's worth on the port's side; the JAX package's tests run
        # on eight virtual CPU devices
        assert info.devices == (1 if spkg == "port" else 8)


def test_raw_bytes_twin_across_the_packages(clients):
    want = _nodes_response(port_wire.pb).SerializeToString()
    assert _nodes_response(jax_wire.pb).SerializeToString() == want
    for (cpkg, spkg), (_, workload) in clients.items():
        raw = workload.NodesBytes(_PB[cpkg].NodesRequest(names=["n1"]), timeout=10)
        assert isinstance(raw, bytes) and raw == want, (cpkg, spkg)
        # the request side takes pre-encoded bytes as well
        assert workload.NodesBytes(b"", timeout=10) == want


def test_failures_carry_the_servers_status_code(clients):
    bad = port_wire.pb.PlaceRequest.FromString(_place_bytes("simplex"))
    for (cpkg, spkg), (client, workload) in clients.items():
        pb = _PB[cpkg]
        err_type = RpcError if cpkg == "port" else grpc.RpcError
        codes = StatusCode if cpkg == "port" else grpc.StatusCode
        with pytest.raises(err_type) as ei:
            client.Place(pb.PlaceRequest.FromString(bad.SerializeToString()), timeout=10)
        assert ei.value.code() == codes.INVALID_ARGUMENT
        assert "simplex" in ei.value.details()
        with pytest.raises(err_type) as ei:
            workload.JobState(pb.JobStateRequest(job_id=1), timeout=10)
        assert ei.value.code() == codes.UNIMPLEMENTED


def test_unavailable_is_retried_as_the_ports_error(tmp_path):
    """No server: the port client's default policy retries UNAVAILABLE
    (the port's RpcError) until its budget ends, then raises it."""
    client = port_rpc.ServiceClient(
        port_rpc.dial(str(tmp_path / "nobody.sock")), "PlacementSolver",
        retry=port_rpc.RetryPolicy(max_attempts=3, base_delay_s=0.01, max_delay_s=0.01),
    )
    before = port_rpc._retries_counter().total()
    try:
        with pytest.raises(RpcError) as ei:
            client.SolverInfo(port_wire.pb.SolverInfoRequest(), timeout=2)
        assert ei.value.code() == StatusCode.UNAVAILABLE
    finally:
        client.close()
    assert port_rpc._retries_counter().total() - before == 2


def test_trace_context_crosses_to_the_ports_server(tmp_path):
    """A call made inside a sampled span reaches the port server's
    tracing interceptor as the parent of its ``rpc.Place`` span."""
    sock = str(tmp_path / "traced.sock")
    server = port_service.serve_solver(sock, _dense(port_auction), device="cpu")
    client = port_rpc.ServiceClient(port_rpc.dial(sock), "PlacementSolver", retry=None)
    mem = InMemoryExporter()
    try:
        with TRACER.recording(mem):
            with TRACER.span("tick"):
                client.Place(port_wire.pb.PlaceRequest.FromString(_place_bytes()), timeout=60)
    finally:
        client.close()
        server.stop(None)
    by_name = {s.name: s for s in mem.spans}
    assert by_name["rpc.Place"].parent_id == by_name["rpc.client.Place"].span_id
    assert by_name["rpc.Place"].trace_id == by_name["tick"].trace_id


def _spawn_worker(package: str, endpoint: str):
    """A fleet worker of ``package`` listening on ``endpoint``, after its
    ready line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", SBT_BACKEND="cpu",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{package}.fleet.worker", "--listen", endpoint,
         "--replica-id", "replica-x", "--incarnation", "replica-x.1"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env, cwd=REPO,
    )
    ready = json.loads(proc.stdout.readline() or "{}")
    return proc, ready


@pytest.mark.parametrize("worker,supervisor", [
    ("slurm_bridge_tpu", port_sidecar),
    ("slurm_bridge_tpu_torch", jax_sidecar),
])
def test_a_fleet_worker_is_adopted_by_the_other_packages_supervisor(tmp_path, worker,
                                                                   supervisor):
    sup = supervisor.SidecarSupervisor("replica-x", str(tmp_path), startup_timeout_s=30)
    proc, ready = _spawn_worker(worker, sup.endpoint)
    sup.proc = proc
    try:
        assert ready.get("ready") is True
        assert sup._adopt("replica-x.1"), sup.down_reason
        pb = port_wire.pb if supervisor is port_sidecar else jax_wire.pb
        resp = sup.client.PlaceShard(pb.PlaceShardRequest.FromString(_place_shard_bytes()),
                                     timeout=30)
        assert resp.engine == "greedy" and resp.rows > 0
    finally:
        sup.stop()
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=10)
        for pipe in (proc.stdout,):
            if pipe is not None:
                pipe.close()
    assert proc.returncode is not None
