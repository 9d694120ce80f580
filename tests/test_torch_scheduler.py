"""The port's PlacementScheduler against the JAX package's, tick for tick.

One world per package, built from the same seeded ``random_inventory``:
pending sizecar pods in that package's ``ObjectStore``, one virtual node
per partition (the last one NotReady until the fourth tick), and
chip_smoke.py's in-process agent in that package's messages, answering as the
simulator's does — the same ``PartitionResponse`` object while membership
is unchanged, ``Nodes`` with a version and ``unchanged=True`` when the
caller's cursor matches — so the incremental cursor and the solve memo
run. Between ticks both worlds take the same steps: bound pods are
submitted and allocate their nodes, new pods arrive, a node drains.

After every tick: pods bound, the tick digest (every pod's node, hint and
reason), ``last_route``, every event of the tick and
``last_explain_ledger`` must be equal. No tolerance.

The JAX side solves the auction densely on the CPU (``use_pallas=False``,
``candidates=0``); the port side with ``device="cpu"``. Each case keeps
its solves under the sharded auto-select floor (P × N < 2^20, with the
JAX package seeing eight host devices) and at two padded shapes, so the
JAX solve compiles at most twice per process.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from chip_smoke import InventoryClient, tick_digest
from tests.test_torch_store import _norm

NODES, JOBS = 400, 1200
SCENARIO = dict(seed=5, load=0.9, gpu_fraction=0.15, gang_fraction=0.1)
CLASSES = ("best-effort", "batch", "production", "system")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


class World:
    """One package's store, agent and scheduler, driven step by step."""

    def __init__(self, pkg: str, case: dict):
        m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
        self.objs = m("bridge.objects")
        self.types = m("core.types")
        partitions, nodes, demands = m("solver.snapshot").random_inventory(
            NODES, JOBS, **SCENARIO
        )
        self.inventory = (partitions, nodes, demands)
        self.agent = InventoryClient(m("wire").pb, m("wire.convert"), partitions, nodes)
        self.store = m("bridge.store").ObjectStore()
        self.events = []
        recorder = m("obs.events").EventRecorder()
        recorder.add_sink(
            lambda ev: self.events.append((ev.reason, ev.kind, ev.name, ev.message, ev.type))
        )
        self.labels = case.get("labels", False)
        self.next_job_id = 1000
        self._add_pods(demands, first=0)
        o = self.objs
        for i, p in enumerate(partitions):
            ready = i < len(partitions) - 1
            self.store.create(o.VirtualNode(
                meta=o.Meta(name=o.partition_node_name(p.name)), partition=p.name,
                conditions=[o.NodeCondition(status=ready)],
            ))
        kw = dict(
            backend=case["backend"], inventory_ttl=0.0, events=recorder,
            preemption=case.get("preemption", False),
            explain=case.get("explain", True),
            incremental=case.get("incremental", False),
        )
        if case.get("policy"):
            pol = m("policy")
            kw["policy"] = pol.PlacementPolicy(pol.PolicyConfig())
        if case.get("admission"):
            kw["admission"] = m("admission").AdmissionConfig()
        auction = m("solver.auction").AuctionConfig
        if pkg == "slurm_bridge_tpu":
            kw["auction_config"] = auction(rounds=8, candidates=0, use_pallas=False)
        else:
            kw["auction_config"] = auction(rounds=8, candidates=0)
            kw["device"] = "cpu"
        self.sched = m("bridge.scheduler").PlacementScheduler(self.store, self.agent, **kw)

    def _add_pods(self, demands, first: int) -> None:
        o = self.objs
        rng = np.random.default_rng(first + 17)
        pods = []
        for j, d in enumerate(demands, start=first):
            labels = {}
            if self.labels:
                labels = {"sbt.kubecluster.org/priority-class": CLASSES[int(rng.integers(4))],
                          "sbt.kubecluster.org/tenant": f"t{int(rng.integers(3))}"}
            pods.append(o.Pod(
                meta=o.Meta(name=f"pod{j:05d}", uid=f"uid-{j}", labels=labels),
                spec=o.PodSpec(role=o.PodRole.SIZECAR, partition=d.partition, demand=d),
            ))
        self.store.create_batch(pods)

    def settle(self) -> None:
        """Every bound pod not yet submitted is submitted: it gets a job
        id and runs, and its nodes' allocation grows by its share."""
        o = self.objs
        for pod in self.store.list(o.Pod.KIND):
            if not pod.spec.node_name or pod.status.job_ids:
                continue
            d = pod.spec.demand
            jid = self.next_job_id
            self.next_job_id += 1

            def run(p, jid=jid):
                p.status.job_ids = (jid,)
                p.status.phase = o.PodPhase.RUNNING

            self.store.mutate(o.Pod.KIND, pod.name, run)
            share = -(-d.total_cpus() // max(1, d.nodes))
            for host in pod.spec.placement_hint:
                n = self.agent.nodes[host]
                self.agent.replace_node(dataclasses.replace(
                    n, alloc_cpus=min(n.cpus, n.alloc_cpus + share),
                    alloc_memory_mb=min(n.memory_mb,
                                        n.alloc_memory_mb + share * (d.mem_per_cpu_mb or 1024)),
                ))

    def arrive(self, count: int, priority: int) -> None:
        """``count`` new pods at ``priority``, copies of the first jobs'
        shapes."""
        base = self.inventory[2][:count]
        self._add_pods(
            [dataclasses.replace(d, priority=priority) for d in base],
            first=JOBS + len([p for p in self.store.list(self.objs.Pod.KIND)
                              if int(p.meta.name[3:]) >= JOBS]),
        )

    def drain(self, name: str) -> None:
        self.agent.replace_node(dataclasses.replace(self.agent.nodes[name], state="DRAINED"))

    def ready_all(self) -> None:
        vn = self.objs.VirtualNode
        for v in self.store.list(vn.KIND):
            if not v.ready:
                self.store.mutate(
                    vn.KIND, v.name,
                    lambda x: setattr(x, "conditions", [self.objs.NodeCondition()]),
                )

    def admit(self, names):
        return [dataclasses.astuple(self.sched.admit(n)) for n in names]

    def tick(self) -> dict:
        self.events.clear()
        placed = self.sched.tick()
        return {
            "placed": placed,
            "digest": tick_digest(self.store.list(self.objs.Pod.KIND)),
            "route": self.sched.last_route,
            "events": list(self.events),
            "ledger": self.sched.last_explain_ledger,
            "solves": (self.sched.solves_total, self.sched.solve_reuses_total),
            "cancelled": list(self.agent.cancelled),
        }


CASES = {
    "greedy": dict(backend="greedy"),
    "auto": dict(backend="auto", preemption=True),
    "auction": dict(backend="auction"),
    "preemption": dict(backend="auction", preemption=True),
    "policy": dict(backend="auction", preemption=True, policy=True, labels=True),
    "admission": dict(backend="auction", admission=True, labels=True),
    "explain_off": dict(backend="auction", explain=False),
    "incremental": dict(backend="auction", incremental=True),
}


def _run(world: World, case: dict) -> list:
    """The step sequence both packages take; one record per tick."""
    out = [world.tick()]
    world.settle()
    world.arrive(60, priority=200)
    if case.get("admission"):
        out.append({"admit": world.admit([f"pod{JOBS + k:05d}" for k in range(60)])})
    out.append(world.tick())
    world.settle()
    world.drain(sorted(world.agent.nodes)[3])
    world.ready_all()
    out.append(world.tick())
    # submit and tick until a tick binds nothing, then once more:
    # unchanged inputs, the memo tick when incremental
    for _ in range(6):
        world.settle()
        out.append(world.tick())
        if not out[-1]["placed"]:
            break
    out.append(world.tick())
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_tick_matches_jax_package(name):
    case = CASES[name]
    ref_world = World("slurm_bridge_tpu", case)
    port_world = World("slurm_bridge_tpu_torch", case)
    assert _norm(port_world.inventory) == _norm(ref_world.inventory)
    ref = _run(ref_world, case)
    port = _run(port_world, case)
    assert len(port) == len(ref)
    for i, (got, want) in enumerate(zip(port, ref)):
        for key in want:
            assert got[key] == want[key], f"{name}: step {i}: {key} differs"
    # the matrix exercises what it claims
    ticks = [r for r in ref if "placed" in r]
    assert ticks[0]["placed"] > 0
    if case["backend"] == "auction":
        assert ticks[0]["route"] == "auction"
    if case.get("incremental"):
        assert any(r["route"] == "memo" for r in ticks)
    if case.get("preemption") and case["backend"] == "auction":
        assert ticks[-1]["cancelled"], "no incumbent was preempted"
    if case.get("explain", True):
        assert any(r["ledger"] for r in ticks)
    if case.get("admission"):
        admits = [r for r in ref if "admit" in r][0]["admit"]
        assert any(a[1] for a in admits), "the fast path bound nothing"


def test_incremental_memo_skips_the_solver():
    """Twin of tests/test_incremental.py's memo reuse: two more ticks over
    the same unschedulable backlog and inventory invoke no solver and
    write nothing."""
    from slurm_bridge_tpu_torch.bridge.objects import Meta, Pod, PodRole, PodSpec
    from slurm_bridge_tpu_torch.bridge.scheduler import PlacementScheduler
    from slurm_bridge_tpu_torch.bridge.store import ObjectStore
    from slurm_bridge_tpu_torch.core.types import JobDemand, NodeInfo, PartitionInfo
    from slurm_bridge_tpu_torch.wire import pb
    from slurm_bridge_tpu_torch.wire import convert

    nodes = [NodeInfo(name=f"n{i}", cpus=4, memory_mb=8000) for i in range(3)]
    agent = InventoryClient(
        pb, convert, [PartitionInfo(name="part0", nodes=tuple(n.name for n in nodes))], nodes
    )
    store = ObjectStore()
    store.create(Pod(
        meta=Meta(name="greedy"),
        spec=PodSpec(role=PodRole.SIZECAR, partition="part0", demand=JobDemand(
            partition="part0", script="#!/bin/sh\ntrue\n", cpus_per_task=64,
            job_name="greedy",
        )),
    ))
    sched = PlacementScheduler(store, agent, inventory_ttl=0.0, incremental=True, device="cpu")
    assert sched.tick() == 0
    assert sched.solves_total == 1
    rv_after_first = store.changes_since(Pod.KIND, 0)[0]
    assert sched.tick() == 0
    assert sched.tick() == 0
    assert sched.solves_total == 1  # solver never invoked again
    assert sched.solve_reuses_total == 2
    assert sched.last_route == "memo"
    assert store.changes_since(Pod.KIND, 0)[0] == rv_after_first


@pytest.mark.parametrize("backend", ["auction", "auto"])
def test_no_card_no_cpu_solve(backend, monkeypatch):
    """Without a device argument, SBT_BACKEND or a card, the tick raises
    when it comes to solve on the device route: it never solves on the
    CPU instead."""
    from slurm_bridge_tpu_torch.parallel.backend import BackendUnavailable

    monkeypatch.delenv("SBT_BACKEND", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    world = World("slurm_bridge_tpu_torch", dict(backend=backend))
    world.sched.device = None
    with pytest.raises(BackendUnavailable):
        world.sched.tick()
    assert world.sched.last_route == ""
    assert not any(p.spec.node_name for p in world.store.list(world.objs.Pod.KIND))


def test_unported_routes_raise(monkeypatch):
    """Every route of the tick is ported. The forced sharded route runs
    the multi-device sweep (route ``"auction-sharded"``) and binds the JAX
    package's pods — a 1×1 grid on the port's one CPU device, dp4×mp2 on
    the JAX package's eight, which place alike. The auto-select takes it
    with four devices past the floor, before any single-device solve.
    shard= builds the port's executor on the scheduler's device;
    solver_endpoint= dials the PlacementSolver sidecar (no connection is
    made until a tick)."""
    from slurm_bridge_tpu_torch.bridge.scheduler import PlacementScheduler
    from slurm_bridge_tpu_torch.bridge.store import ObjectStore
    from slurm_bridge_tpu_torch.parallel import mesh as port_mesh
    from slurm_bridge_tpu_torch.shard import ShardConfig, ShardExecutor
    from slurm_bridge_tpu_torch.wire.rpc import ServiceClient

    sharded = PlacementScheduler(ObjectStore(), None, shard=ShardConfig(), device="cpu")
    assert isinstance(sharded.shard, ShardExecutor) and sharded.shard.device == "cpu"
    remote = PlacementScheduler(ObjectStore(), None, solver_endpoint="unix:///x.sock",
                                device="cpu")
    assert isinstance(remote._remote, ServiceClient)
    remote._remote.close()

    want = World("slurm_bridge_tpu", dict(backend="auction"))
    want.sched.sharded = True
    explicit = World("slurm_bridge_tpu_torch", dict(backend="auction"))
    explicit.sched.sharded = True
    got = explicit.tick()
    assert got == want.tick()
    assert got["route"] == "auction-sharded" and got["placed"] > 0
    assert explicit.sched._solver is None

    cpu = torch.device("cpu")
    monkeypatch.setattr(port_mesh, "process_devices", lambda backend: [cpu] * 4)
    auto = World("slurm_bridge_tpu_torch", dict(backend="auction"))
    auto.sched.sharded_threshold = 1
    tick = auto.tick()
    assert tick["route"] == "auction-sharded" and tick["digest"] == got["digest"]
    assert auto.sched._solver is None


#: one change per field a Nodes response carries
_RESPONSE_EDITS = [
    ("same", lambda r: None),
    ("name", lambda r: setattr(r.nodes[1], "name", "other")),
    ("cpus", lambda r: setattr(r.nodes[0], "cpus", 65)),
    ("alloc_cpus", lambda r: setattr(r.nodes[0], "alloc_cpus", 3)),
    ("memory_mb", lambda r: setattr(r.nodes[0], "memory_mb", 1)),
    ("alloc_memory_mb", lambda r: setattr(r.nodes[0], "alloc_memory_mb", 7)),
    ("gpus", lambda r: setattr(r.nodes[0], "gpus", 8)),
    ("alloc_gpus", lambda r: setattr(r.nodes[0], "alloc_gpus", 1)),
    ("gpu_type", lambda r: setattr(r.nodes[0], "gpu_type", "h100")),
    ("features", lambda r: r.nodes[0].features.append("ib")),
    ("state", lambda r: setattr(r.nodes[0], "state", "DRAINED")),
    ("drop", lambda r: r.nodes.pop()),
    ("version", lambda r: setattr(r, "version", 9)),
    ("unchanged", lambda r: setattr(r, "unchanged", True)),
]


@pytest.mark.parametrize("edit", [name for name, _ in _RESPONSE_EDITS])
def test_nodes_decode_cache_keys_on_content_like_the_jax_package(edit):
    """Both packages' NodesDecodeCache key on the serialized bytes (the
    port's from its own codec): across a fresh response equal to the
    last, and one with ``edit`` applied, both replay or both decode."""
    fn = dict(_RESPONSE_EDITS)[edit]
    hits = {}
    for pkg in ("slurm_bridge_tpu", "slurm_bridge_tpu_torch"):
        pb = importlib.import_module(f"{pkg}.wire").pb
        convert = importlib.import_module(f"{pkg}.wire.convert")

        def response(pb=pb):
            return pb.NodesResponse(nodes=[
                pb.Node(name=f"n{i}", cpus=64, memory_mb=1024, features=["gpu_type0"])
                for i in range(3)
            ], version=4)

        cache = convert.NodesDecodeCache()
        first = cache.decode(response())
        assert cache.decode(response()) is first  # equal content, new object
        edited = response()
        fn(edited)
        hits[pkg] = cache.decode(edited) is first
    assert hits["slurm_bridge_tpu_torch"] == hits["slurm_bridge_tpu"]
    assert hits["slurm_bridge_tpu"] == (edit == "same")
