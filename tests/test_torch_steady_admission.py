"""The steady-state tick and the streaming-admission fast path: the port
against the JAX package, with the engine pinned as chip_smoke.py pins it
on the card (``backend="auction"``, ``AuctionConfig(rounds=8,
candidates=0)``, every shard on the single-device auction).

(a) A ``*_steady`` scenario is its 3-tick twin run three ticks longer:
    after tick 2 its running trace digest and ``final_state_digest`` equal
    the end of the twin's run, in both packages. chip_smoke.py's phases
    [6] and [8] rely on it to hold the 3-tick references at tick 2 of the
    steady run.
(b) The port's steady ticks are O(changes): three of them at these
    scales, each with no solve, no store commit and no call of the
    kernel's wrapper or of its plain version, while the solving ticks go
    through the wrapper (pinned to the kernel route, as on the card).
(c) ``interactive_storm`` at the admission gate's scale, pinned as
    chip_smoke.py phase [14] pins it: the port's digests, bound and
    admission decisions equal the JAX package's.
(d) The port's two repairs of the steady tick's host work: a worker pod
    written on a provider's node keeps the mirror's working set (the JAX
    package reclassifies the node bucket), and the store's
    ``changes_since`` answers as the JAX package's full scan does.

No tolerance: every compared value is exact.
"""

from __future__ import annotations

import dataclasses
import functools

import pytest
import torch

import slurm_bridge_tpu.parallel.colpool as jax_colpool
import slurm_bridge_tpu.sim.harness as jax_harness
import slurm_bridge_tpu.sim.scenarios as jax_scenarios
import slurm_bridge_tpu.solver.auction as jax_auction
import slurm_bridge_tpu_torch.ops.bid_argmax as port_ops
import slurm_bridge_tpu_torch.parallel.colpool as port_colpool
import slurm_bridge_tpu_torch.sim.harness as port_harness
import slurm_bridge_tpu_torch.sim.scenarios as port_scenarios
import slurm_bridge_tpu_torch.solver.auction as port_auction
from chip_smoke import STEADY_CHECKPOINT_TICK, pin_auction

#: (steady scenario, its 3-tick twin, scale): tests/test_torch_sim.py's
#: scales for the two shapes
STEADY_CASES = [
    ("full_50kx10k_steady", "full_50kx10k", 0.02),
    ("full_500kx100k_steady", "full_500kx100k", 0.004),
]
#: the JAX package's admission gate runs interactive_storm at this scale
#: (``sim/cli.py`` ``SMOKE_SCALE``)
STORM_SCALE = 0.12
PACKAGES = {"jax": (jax_scenarios, jax_harness), "port": (port_scenarios, port_harness)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _reap_pools(monkeypatch):
    """Two forked pool workers per run, and neither package's pool
    outlives a test."""
    monkeypatch.setenv("SBT_COLPOOL_WORKERS", "2")
    yield
    port_colpool.reset()
    jax_colpool.reset()


def _pinned(pkg: str, name: str, scale: float, **auction):
    sc = PACKAGES[pkg][0].SCENARIOS[name](scale=scale)
    if pkg == "port":
        sc = pin_auction(sc)
    else:
        sc = dataclasses.replace(
            sc, backend="auction",
            auction_config=jax_auction.AuctionConfig(rounds=8, candidates=0),
        )
        if sc.sharding is not None:
            sc = dataclasses.replace(
                sc, sharding=dataclasses.replace(sc.sharding, device_solve=False)
            )
    if auction:
        sc = dataclasses.replace(
            sc, auction_config=dataclasses.replace(sc.auction_config, **auction)
        )
    return sc


def _harness(pkg: str, sc):
    harness = PACKAGES[pkg][1]
    return harness.SimHarness(sc, device="cpu") if pkg == "port" else harness.SimHarness(sc)


@functools.lru_cache(maxsize=None)
def _steady_run(pkg: str, name: str, scale: float):
    """A ``*_steady`` run: its result, the running trace digest and the
    state after tick 2, and (port) each tick's calls of the kernel's
    wrapper and of its plain version, the kernel route pinned."""
    auction = {"use_pallas": True} if pkg == "port" else {}
    h = _harness(pkg, _pinned(pkg, name, scale, **auction))
    at, calls = {}, []
    count = {"wrapper": 0, "plain": 0}
    real_tick = h.run_tick
    real_wrapper, real_plain = port_auction.bid_argmax, port_ops.bid_argmax_plain

    def wrapper(*a, **kw):
        count["wrapper"] += 1
        return real_wrapper(*a, **kw)

    def plain(*a, **kw):
        count["plain"] += 1
        return real_plain(*a, **kw)

    def run_tick(tick, **kw):
        before = dict(count)
        phases = real_tick(tick, **kw)
        calls.append({k: count[k] - before[k] for k in count})
        if tick == STEADY_CHECKPOINT_TICK:
            at.update(digest=h._digest.copy().hexdigest(),
                      final_state_digest=h._final_state_digest())
        return phases

    h.run_tick = run_tick
    port_auction.bid_argmax, port_ops.bid_argmax_plain = wrapper, plain
    try:
        result = h.run()
    finally:
        port_auction.bid_argmax, port_ops.bid_argmax_plain = real_wrapper, real_plain
    return result, at, list(h._tick_meta), calls


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("name,twin,scale", STEADY_CASES)
def test_steady_run_after_tick_2_equals_its_3_tick_twin(pkg, name, twin, scale):
    _, at, _, _ = _steady_run(pkg, name, scale)
    end = _harness(pkg, _pinned(pkg, twin, scale)).run().determinism
    assert at == {"digest": end["digest"], "final_state_digest": end["final_state_digest"]}


@pytest.mark.parametrize("name,twin,scale", STEADY_CASES)
def test_steady_ticks_solve_commit_and_launch_nothing(name, twin, scale):
    result, _, meta, calls = _steady_run("port", name, scale)
    assert result.timing["steady_ticks"] == 3
    steady = [i for i, m in enumerate(meta) if m["steady"]]
    assert steady == [3, 4, 5]
    for i in steady:
        assert (meta[i]["solves"], meta[i]["commits"]) == (0, 0), meta[i]
        assert calls[i] == {"wrapper": 0, "plain": 0}, (i, calls[i])
    # the solving ticks went through the wrapper, 8 rounds per solve
    solving = [i for i, m in enumerate(meta) if m["solves"]]
    assert solving and all(calls[i]["wrapper"] == 8 * meta[i]["solves"] for i in solving)
    assert all(calls[i]["plain"] == calls[i]["wrapper"] for i in solving)
    # and the run is the JAX package's
    jax_result, _, jax_meta, _ = _steady_run("jax", name, scale)
    for key in ("digest", "final_state_digest", "bound_total"):
        assert result.determinism[key] == jax_result.determinism[key], key
    assert [m["steady"] for m in meta] == [m["steady"] for m in jax_meta]


def test_interactive_storm_equals_the_jax_packages():
    jax_r = _harness("jax", _pinned("jax", "interactive_storm", STORM_SCALE)).run()
    port_r = _harness("port", _pinned("port", "interactive_storm", STORM_SCALE)).run()
    for key in ("digest", "final_state_digest", "bound_total", "admission",
                "invariant_violations"):
        assert port_r.determinism[key] == jax_r.determinism[key], key
    for key in ("interactive_arrivals", "fastpath_binds", "admission_misses"):
        assert port_r.quality[key] == jax_r.quality[key], key
    adm = port_r.determinism["admission"]
    assert adm["misses"].get("not_ready", 0) > 0 and port_r.quality["fastpath_binds"] >= 10


def _converged_provider(pkg: str, n_pods: int = 6):
    """One incremental provider of either package over a simulated
    partition, its sizecar pods submitted, mirrored and Running."""
    import importlib

    root = "slurm_bridge_tpu" if pkg == "jax" else "slurm_bridge_tpu_torch"
    objects = importlib.import_module(f"{root}.bridge.objects")
    agent = importlib.import_module(f"{root}.sim.agent")
    store = importlib.import_module(f"{root}.bridge.store").ObjectStore()
    types = importlib.import_module(f"{root}.core.types")
    events = importlib.import_module(f"{root}.obs.events")
    vnode = importlib.import_module(f"{root}.bridge.vnode")
    clock = [0.0]
    nodes = [agent.SimNode(name=f"n{i}", cpus=16, memory_mb=32000) for i in range(4)]
    cluster = agent.SimCluster(nodes, {"part0": tuple(n.name for n in nodes)},
                               clock=lambda: clock[0])
    provider = vnode.VirtualNodeProvider(
        store, agent.SimWorkloadClient(cluster), "part0", events=events.EventRecorder(),
        sync_workers=1, inventory_ttl=0.0, status_interval=3600.0, incremental=True,
    )
    node = objects.partition_node_name("part0")
    for i in range(n_pods):
        store.create(objects.Pod(
            meta=objects.Meta(name=f"bp{i}"),
            spec=objects.PodSpec(
                role=objects.PodRole.SIZECAR, partition="part0", node_name=node,
                demand=types.JobDemand(partition="part0", script="#!/bin/sh\ntrue\n",
                                       cpus_per_task=1, time_limit_s=1000,
                                       job_name=f"bp{i}"),
            ),
        ))
    for _ in range(3):  # submit, mirror, settle
        provider.sync()
    assert all(p.status.phase == objects.PodPhase.RUNNING for p in store.list(objects.Pod.KIND))
    return objects, store, provider, node


def _add_worker(objects, store, node: str, name: str):
    store.create(objects.Pod(
        meta=objects.Meta(name=name, owner="bp0"),
        spec=objects.PodSpec(role=objects.PodRole.WORKER, partition="part0", node_name=node),
    ))


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_a_worker_pod_write_keeps_the_mirrors_working_set(pkg):
    """A worker pod written on the provider's node (the operator's
    per-sub-job display pod) needs no classification: the port's scoped
    rescan skips it and keeps the working set, where the JAX package
    reclassifies the whole node bucket (``full_50kx10k_steady``'s first
    steady tick on the card: 241 ms against the 50 ms gate). Both end in
    the same pod states."""
    objects, store, provider, node = _converged_provider(pkg)
    mc, full = provider._mirror_cache, provider.mirror_scans_full
    applied = provider._applied_ids
    _add_worker(objects, store, node, "bp0-worker")
    provider.sync()
    store.mutate(objects.Pod.KIND, "bp0-worker",
                 lambda p: p.meta.annotations.__setitem__("x", "1"))
    provider.sync()
    if pkg == "port":
        assert provider._mirror_cache is mc
        assert provider.mirror_scans_full == full
        # the cursor passes over the same working set kept its applied ids
        assert provider._applied_ids is applied
    else:
        assert provider.mirror_scans_full == full + 2
    phases = {p.name: (p.status.phase, tuple(p.status.job_ids)) for p in store.list(objects.Pod.KIND)}
    assert phases["bp0-worker"][1] == ()
    assert sum(ph == objects.PodPhase.RUNNING for ph, _ in phases.values()) == 6


def test_a_deleted_worker_pod_still_reclassifies():
    """A deleted pod on the node is the provider's deletion work, of any
    role: the scoped rescan still hands it to the full classification."""
    objects, store, provider, node = _converged_provider("port")
    _add_worker(objects, store, node, "bp0-worker")
    provider.sync()
    full = provider.mirror_scans_full
    store.mutate(objects.Pod.KIND, "bp0-worker",
                 lambda p: setattr(p.meta, "deleted", True))
    provider.sync()
    assert provider.mirror_scans_full == full + 1


def _pod(objects, types, name: str, node: str = ""):
    return objects.Pod(
        meta=objects.Meta(name=name),
        spec=objects.PodSpec(
            role=objects.PodRole.SIZECAR, partition="part0", node_name=node,
            demand=types.JobDemand(partition="part0", script="#!/bin/sh\ntrue\n",
                                   cpus_per_task=1, time_limit_s=60, job_name=name),
        ),
    )


#: (pods created first, the write log's least size): a small store that
#: mostly scans, and a large one that reads its log, with and without
#: the log dropped along the way
LOG_CASES = [(0, 4), (5_000, 4), (5_000, 65_536)]


@pytest.mark.parametrize("initial,log_min", LOG_CASES)
def test_changes_since_answers_as_the_jax_packages_scan(initial, log_min, monkeypatch):
    """The port's ``changes_since`` reads the writes after the cursor
    from its write log (and scans, as the JAX package always does, for a
    cursor older than the log or when most names moved); the same random
    creates, updates and deletes give both stores the same answer at the
    recent cursors after every step, and at every cursor at the end."""
    import importlib

    import numpy as np

    pkgs = {}
    for pkg, root in (("jax", "slurm_bridge_tpu"), ("port", "slurm_bridge_tpu_torch")):
        pkgs[pkg] = tuple(importlib.import_module(f"{root}.{m}") for m in
                          ("bridge.objects", "core.types", "bridge.store"))
    monkeypatch.setattr(pkgs["port"][2].ObjectStore, "WRITE_LOG_MIN", log_min)
    stores = {pkg: mods[2].ObjectStore() for pkg, mods in pkgs.items()}
    kind = pkgs["port"][0].Pod.KIND
    rng = np.random.default_rng(3)
    live = [f"init-{i}" for i in range(initial)]
    for pkg, (objects, types, _) in pkgs.items():
        stores[pkg].create_batch([_pod(objects, types, n) for n in live])
    cursors = [0, stores["port"].current_rv()]

    def same(since):
        assert (stores["port"].changes_since(kind, since)
                == stores["jax"].changes_since(kind, since)), since

    for step in range(160):
        op = rng.integers(6)
        # the names written lately: deleting or rewriting one of them is
        # what the log's answer has to filter
        recent = live[-40:]
        if op == 0 or not live:
            names = [f"p{step}-{i}" for i in range(int(rng.integers(1, 9)))]
            for pkg, (objects, types, _) in pkgs.items():
                stores[pkg].create_batch([_pod(objects, types, n) for n in names])
            live += names
        elif op == 1:
            name = recent[int(rng.integers(len(recent)))]
            for pkg, (objects, _, _) in pkgs.items():
                stores[pkg].mutate(objects.Pod.KIND, name,
                                   lambda p, s=step: p.meta.annotations.__setitem__("s", str(s)))
        elif op == 2:
            name = live.pop(len(live) - 1 - int(rng.integers(len(recent))))
            for pkg, (objects, _, _) in pkgs.items():
                stores[pkg].delete(objects.Pod.KIND, name)
        elif op == 5:
            # a partitioned commit merge (the mirror's frames), whose
            # names land in a writer partition's dirty set
            names = sorted({recent[int(i)] for i in rng.integers(len(recent), size=4)})
            part = [None, 0, 1][int(rng.integers(3))]
            for pkg in pkgs:
                stores[pkg].apply_frames(kind, [(names, None, lambda rows, sel: None)],
                                         partition=part)
        else:
            # a bulk rewrite: a few names, or a large share of the store
            # (a log dropped beyond twice the dirty names)
            k = min(len(live), 5 if op == 3 else max(5, initial // 4))
            batch = [live[int(i)] for i in rng.choice(len(live), k, replace=False)]
            for pkg, (objects, _, _) in pkgs.items():
                stores[pkg].update_batch([
                    stores[pkg].get_for_update(objects.Pod.KIND, n) for n in batch
                ])
        cursors.append(stores["port"].current_rv())
        for since in cursors[-8:]:
            same(since)
    for since in cursors:
        same(since)
