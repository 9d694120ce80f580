"""The bridge's daemons across the two packages, on the CPU.

Each package's agent (``WorkloadServicer`` over the fake Slurm CLI,
``tests/fakeslurm``) serves the other package's ``Bridge`` over gRPC, the
two agents answer one request sequence with the same bytes, and the two
``Bridge``s make the same first placing tick over one inventory (the
auction pinned as chip_smoke.py pins it: ``rounds=8, candidates=0``, and
``use_pallas=False`` for the JAX package). The port's ``Bridge`` makes that
tick over chip_smoke.py's ``LoopbackChannel`` too — the transport phase
[11] uses on the card, which has no grpc.

The world is chip_smoke.py's at a small width: ``bridge_inventory`` of 64
nodes (the headline's shape and jobs per node), its first 40 demands as
``BridgeJob``s whose scripts echo a marker, written into a fake-Slurm
``cluster.json`` by ``fake_cluster``.
"""

from __future__ import annotations

import json
import os
import pathlib

import pytest

from chip_smoke import (
    bridge_first_tick,
    bridge_inventory,
    bridge_jobs,
    fake_cluster,
    job_marker,
    loopback_dial,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
FAKESLURM = str(REPO / "tests" / "fakeslurm")
NODES, JOBS = 64, 40


@pytest.fixture(autouse=True)
def _pools_and_backend(monkeypatch):
    """The port's Bridge on the CPU, two forked pool workers per package,
    and neither package's pool outlives the test."""
    from slurm_bridge_tpu.parallel import colpool as jax_colpool
    from slurm_bridge_tpu_torch.parallel import colpool as port_colpool

    monkeypatch.setenv("SBT_COLPOOL_WORKERS", "2")
    monkeypatch.setenv("PATH", FAKESLURM + os.pathsep + os.environ["PATH"])
    yield
    port_colpool.reset()
    jax_colpool.reset()


def _world():
    from slurm_bridge_tpu_torch.solver.snapshot import random_inventory

    return bridge_inventory(random_inventory, NODES, JOBS)


def _slurm_state(root: pathlib.Path, monkeypatch) -> pathlib.Path:
    """A fresh fake-Slurm state directory holding the world's inventory,
    made the CLI's current one."""
    partitions, nodes, _ = _world()
    root.mkdir(parents=True)
    (root / "cluster.json").write_text(json.dumps(fake_cluster(partitions, nodes)))
    monkeypatch.setenv("SBT_FAKESLURM_STATE", str(root))
    return root


def _package(name: str):
    """(agent, bridge, objects, wire, AuctionConfig pinned as chip_smoke.py
    pins it, Bridge keywords) of one package."""
    if name == "jax":
        import slurm_bridge_tpu.agent as agent
        import slurm_bridge_tpu.bridge as bridge
        import slurm_bridge_tpu.bridge.objects as objects
        import slurm_bridge_tpu.wire as wire
        from slurm_bridge_tpu.solver import AuctionConfig

        return (agent, bridge, objects, wire,
                AuctionConfig(rounds=8, candidates=0, use_pallas=False), {})
    import slurm_bridge_tpu_torch.agent as agent
    import slurm_bridge_tpu_torch.bridge as bridge
    import slurm_bridge_tpu_torch.bridge.objects as objects
    import slurm_bridge_tpu_torch.wire as wire
    from slurm_bridge_tpu_torch.solver import AuctionConfig

    return agent, bridge, objects, wire, AuctionConfig(rounds=8, candidates=0), {"device": "cpu"}


def _serve_agent(pkg: str, sock: str):
    agent, _, _, wire, _, _ = _package(pkg)
    servicer = agent.WorkloadServicer(agent.SlurmClient(), tail_poll_interval=0.02)
    return servicer, wire.serve({"WorkloadManager": servicer}, sock)


def _first_tick(pkg: str, endpoint: str, **extra) -> dict:
    _, bridge_mod, objects, _, cfg, kw = _package(pkg)
    bridge = bridge_mod.Bridge(endpoint, scheduler_backend="auction",
                               auction_config=cfg, **kw, **extra)
    try:
        return bridge_first_tick(bridge, objects, bridge_jobs(bridge_mod.BridgeJobSpec, _world()[2]))
    finally:
        bridge.configurator.stop()
        bridge.client.close()


def test_first_placing_tick_equals_across_packages(tmp_path, monkeypatch):
    """Each package's Bridge over its own agent and fake-Slurm state binds
    every job in its first tick; the port's digest is the JAX package's."""
    ticks = {}
    for side in ("jax", "torch"):
        _slurm_state(tmp_path / side / "state", monkeypatch)
        sock = str(tmp_path / side / "agent.sock")
        _, server = _serve_agent(side, sock)
        try:
            ticks[side] = _first_tick(side, sock)
        finally:
            server.stop(None)
        assert ticks[side]["placed"] == JOBS, ticks[side]
        assert ticks[side]["route"] == "auction"
    assert ticks["torch"]["digest"] == ticks["jax"]["digest"]


def test_loopback_channel_tick_equals_grpc(tmp_path, monkeypatch):
    """The port's Bridge makes the same first tick over chip_smoke.py's
    LoopbackChannel as over gRPC, and every RPC of it crossed the
    loopback."""
    import slurm_bridge_tpu_torch.agent as agent

    _slurm_state(tmp_path / "grpc" / "state", monkeypatch)
    sock = str(tmp_path / "grpc" / "agent.sock")
    _, server = _serve_agent("torch", sock)
    try:
        over_grpc = _first_tick("torch", sock)
    finally:
        server.stop(None)
    _slurm_state(tmp_path / "loop" / "state", monkeypatch)
    servicer = agent.WorkloadServicer(agent.SlurmClient(), tail_poll_interval=0.02)
    with loopback_dial(servicer) as channels:
        over_loop = _first_tick("torch", "loopback")
    assert len(channels) == 1 and channels[0].calls > 0
    assert over_loop["placed"] == over_grpc["placed"] == JOBS
    assert over_loop["digest"] == over_grpc["digest"]

    # a servicer's abort crosses as the port's RpcError with its code, and a
    # response stream crosses chunk by chunk
    from chip_smoke import LoopbackChannel
    from slurm_bridge_tpu_torch.wire import RpcError, ServiceClient, StatusCode, pb

    client = ServiceClient(LoopbackChannel(servicer), "WorkloadManager", retry=None)
    with pytest.raises(RpcError) as err:
        client.JobInfo(pb.JobInfoRequest(job_id=999_999))
    assert err.value.code() == StatusCode.NOT_FOUND
    cluster = tmp_path / "loop" / "state" / "cluster.json"
    chunks = list(client.OpenFile(pb.OpenFileRequest(path=str(cluster))))
    assert b"".join(c.content for c in chunks) == cluster.read_bytes()


def _run_jobs(bridge_pkg: str, endpoint: str, results: pathlib.Path, count: int) -> None:
    """``count`` of the world's jobs through a started Bridge of
    ``bridge_pkg``: each must reach Succeeded with its stdout fetched, and
    the fetched file and the job's log must hold its marker."""
    _, bridge_mod, _, _, cfg, kw = _package(bridge_pkg)
    jobs = bridge_jobs(bridge_mod.BridgeJobSpec, _world()[2][:count], str(results))
    with bridge_mod.Bridge(endpoint, scheduler_backend="auction", auction_config=cfg,
                           scheduler_interval=0.05, node_sync_interval=0.05, **kw) as bridge:
        for name, spec in jobs:
            bridge.submit(name, spec)
        for name, _ in jobs:
            job = bridge.wait(name, timeout=60.0, fetch_done=True)
            assert job.status.state == bridge_mod.JobState.SUCCEEDED, (name, job.status)
            assert job.status.fetch_result == bridge_mod.FetchState.SUCCEEDED
            fetched = [f for f in os.listdir(results) if f.startswith(f"{name}-")]
            assert fetched, (name, os.listdir(results))
            assert job_marker(name) in (results / fetched[0]).read_text()
            assert job_marker(name).encode() in b"".join(bridge.logs(name))


@pytest.mark.parametrize("agent_pkg, bridge_pkg", [("jax", "torch"), ("torch", "jax")])
def test_agent_serves_the_other_packages_bridge(agent_pkg, bridge_pkg, tmp_path, monkeypatch):
    """The JAX package's agent over gRPC serves the port's Bridge, and the
    port's agent serves the JAX package's: jobs (a gang among them) reach
    Succeeded with their stdout fetched."""
    _slurm_state(tmp_path / "state", monkeypatch)
    sock = str(tmp_path / "agent.sock")
    _, server = _serve_agent(agent_pkg, sock)
    try:
        _run_jobs(bridge_pkg, sock, tmp_path / "results", count=6)
    finally:
        server.stop(None)


#: fields a run's clock or its state directory decides: blanked before the
#: two agents' responses are compared
TIME_OR_PATH_FIELDS = {
    "JobInfo": ("submit_time", "start_time", "run_time_s", "std_out", "std_err"),
    "JobStepInfo": ("start_time", "finish_time"),
    "NodesResponse": ("version",),
    "JobsInfoResponse": ("version",),
    "WorkloadInfoResponse": ("uid",),
}


def _blank(msg) -> None:
    """Zero the :data:`TIME_OR_PATH_FIELDS` of a port message, in place
    and in every nested message."""
    for f in type(msg).DESCRIPTOR.fields:
        value = getattr(msg, f.name)
        if f.name in TIME_OR_PATH_FIELDS.get(type(msg).__name__, ()):
            setattr(msg, f.name, type(value)())
        elif isinstance(value, (list, tuple)) or f.is_repeated:
            for item in value:
                if hasattr(item, "SerializeToString"):
                    _blank(item)
        elif hasattr(value, "SerializeToString"):
            _blank(value)


def _request_sequence(pb, stdout_of):
    """The requests sent to both agents, in order, in a package's ``pb``;
    ``stdout_of(job_id)`` names the job's stdout file for ``OpenFile``."""
    first = pb.SubmitJobRequest(script="#!/bin/sh\necho one\n", partition="part1",
                                cpus_per_task=2, submitter_id="sub-1")
    yield "Partitions", pb.PartitionsRequest()
    yield "Partition", pb.PartitionRequest(partition="part1")
    yield "Resources", pb.ResourcesRequest(partition="part2")
    yield "Nodes", pb.NodesRequest(names=["node00003", "node00007", "node00011"])
    yield "SubmitJob", first
    yield "SubmitJob", first  # the ledger's dedupe
    batch = pb.SubmitJobsRequest()
    # one good item and one the fake sbatch rejects before it takes a job
    # id: the agent submits a batch's items on a thread pool, so two that
    # take ids could take them either way round
    batch.requests.add(script="#!/bin/sh\necho batch\n", partition="part0",
                       submitter_id="batch-0")
    batch.requests.add(script="#!/bin/sh\necho fail-submit\n", partition="part3",
                       submitter_id="batch-1")
    yield "SubmitJobs", batch
    yield "SubmitJob", pb.SubmitJobRequest(script="#!/bin/sh\necho x\n", partition="nope")
    yield "WAIT", None
    yield "JobInfo", pb.JobInfoRequest(job_id=100)
    yield "JobsInfo", pb.JobsInfoRequest(job_ids=[100, 101, 999])
    yield "JobState", pb.JobStateRequest(job_id=101)
    yield "JobSteps", pb.JobStepsRequest(job_id=100)
    yield "OpenFile", pb.OpenFileRequest(path=stdout_of(100))
    yield "CancelJob", pb.CancelJobRequest(job_id=101)
    yield "JobInfo", pb.JobInfoRequest(job_id=999)
    yield "WorkloadInfo", pb.WorkloadInfoRequest()


def _answers(pkg: str, tmp_path: pathlib.Path, monkeypatch) -> list:
    """Each response of :func:`_request_sequence` from ``pkg``'s agent over
    gRPC, serialized, parsed into the port's messages and blanked; a
    failed call as its status code and message."""
    import time

    from slurm_bridge_tpu_torch.wire import rpc as port_rpc

    state = _slurm_state(tmp_path / pkg / "state", monkeypatch)
    sock = str(tmp_path / pkg / "agent.sock")
    _, _, _, wire, _, _ = _package(pkg)
    _, server = _serve_agent(pkg, sock)
    _, port_specs = port_rpc.service_methods("WorkloadManager")
    resp_cls = {m.name: m.resp_cls for m in port_specs}
    out = []
    try:
        with wire.ServiceClient(wire.dial(sock), "WorkloadManager", retry=None) as client:
            for method, req in _request_sequence(wire.pb, lambda j: str(state / f"slurm-{j}.out")):
                if method == "WAIT":  # every submitted script has ended
                    deadline = time.monotonic() + 20
                    while time.monotonic() < deadline and not all(
                        (state / f"exit_{j}").exists() for j in (100, 101)
                    ):
                        time.sleep(0.05)
                    continue
                try:
                    resp = getattr(client, method)(req)
                except Exception as err:  # either package's RpcError
                    out.append((method, "error", err.code().name, err.details()))
                    continue
                chunks = list(resp) if method == "OpenFile" else [resp]
                for r in chunks:
                    msg = resp_cls[method].FromString(r.SerializeToString())
                    _blank(msg)
                    out.append((method, msg.SerializeToString()))
    finally:
        server.stop(None)
    return out


def test_agents_answer_the_same_bytes(tmp_path, monkeypatch):
    """One request sequence — inventory, submits (a dedupe, a batch with a
    bad partition), status, steps, file, cancel, a missing job — sent to
    each package's agent over its own fake-Slurm state gives byte-equal
    serialized responses once the clock's and the state directory's
    fields are blanked."""
    jax_side = _answers("jax", tmp_path, monkeypatch)
    port_side = _answers("torch", tmp_path, monkeypatch)
    assert [a[0] for a in port_side] == [a[0] for a in jax_side]
    assert any(a[1] == "error" for a in jax_side)  # the missing job's NOT_FOUND
    for want, got in zip(jax_side, port_side):
        assert got == want, want[0]


def test_port_bridge_needs_the_card_or_the_cpu(monkeypatch):
    """Without a card, and without device="cpu" or SBT_BACKEND=cpu, the
    port's Bridge raises before it dials or builds anything."""
    import torch

    from slurm_bridge_tpu_torch.bridge import Bridge
    from slurm_bridge_tpu_torch.parallel.backend import BackendUnavailable

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    monkeypatch.delenv("SBT_BACKEND", raising=False)
    with pytest.raises(BackendUnavailable):
        Bridge("unused.sock")
