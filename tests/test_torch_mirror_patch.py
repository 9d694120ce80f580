"""The mirror's working set kept across churn syncs (``bridge/vnode.py``):
each incremental provider sync patches it for the pods written since the
last one — joins, leaves, status moves — instead of reclassifying the
provider's node bucket, and what it keeps is what a full classification
of the same store builds. A submit that failed transiently is retried on
the next sync, and an id submitted on one sync is queried in full on the
next."""

from __future__ import annotations

import math
import os
import sys
import threading

import numpy as np
import pytest
import torch

from slurm_bridge_tpu_torch.bridge.objects import (
    Meta,
    Pod,
    PodPhase,
    PodRole,
    PodSpec,
    partition_node_name,
)
from slurm_bridge_tpu_torch.bridge.store import ObjectStore
from slurm_bridge_tpu_torch.bridge.vnode import _BULK_CHUNK, VirtualNodeProvider
from slurm_bridge_tpu_torch.core.types import JobDemand
from slurm_bridge_tpu_torch.obs.events import EventRecorder
from slurm_bridge_tpu_torch.sim.agent import SimCluster, SimNode, SimWorkloadClient
from slurm_bridge_tpu_torch.sim.harness import Scenario, SimHarness
from slurm_bridge_tpu_torch.sim.trace import ClusterSpec, WorkloadSpec
from slurm_bridge_tpu_torch.solver.auction import AuctionConfig
from slurm_bridge_tpu_torch.wire import RpcError, StatusCode


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _assert_same_working_set(provider, table, mc, items) -> None:
    """``(mc, items)`` from a patch equals a full classification of the
    store as it stands: the refresh batch field by field in name order,
    the submit items in order, no deletions, the id set, the chunk count,
    the routes, and every never-applied id in a chunk queried in full."""
    f_items, f_work, f_rb = provider._classify_full(table)
    assert f_work == []
    assert [tuple(it) for it in items] == [tuple(it) for it in f_items]
    rb = mc.rb
    if f_rb is None:
        assert rb.names == [] and len(mc.ids) == 0
        return
    assert rb.names == f_rb.names
    assert rb.job_ids == f_rb.job_ids
    for field in ("rv", "phase", "ilen"):
        got, want = getattr(rb, field), getattr(f_rb, field)
        assert got.dtype == want.dtype, field
        assert np.array_equal(got, want), field
    built = provider._build_mirror_cache(f_rb)
    ids = mc.ids.tolist()
    assert len(set(ids)) == len(ids)
    assert set(ids) == set(built.ids.tolist())
    assert len(mc.reqs) == len(built.reqs) == math.ceil(len(ids) / _BULK_CHUNK)
    assert [j for req in mc.reqs for j in req.job_ids] == ids
    assert {j: set(n) for j, n in mc.names_of_jid.items()} == {
        j: set(n) for j, n in built.names_of_jid.items()
    }
    assert mc.idx_of_name == {n: i for i, n in enumerate(f_rb.names)}
    applied = provider._applied_ids
    assert all(u or j in applied for j, u in zip(ids, mc.unapplied.tolist()))
    for k, full in enumerate(mc.full_chunk):
        assert full == bool(mc.unapplied[k * _BULK_CHUNK : (k + 1) * _BULK_CHUNK].any())


def _churn() -> Scenario:
    """Two partitions under a Poisson stream of short jobs: every tick
    binds, submits and completes pods on both providers' nodes."""
    return Scenario(
        name="mirror-patch-churn",
        cluster=ClusterSpec(num_nodes=48, num_partitions=2),
        workload=WorkloadSpec(jobs=360, arrival="poisson", spread_ticks=10,
                              duration_range=(5.0, 15.0)),
        ticks=14,
        seed=11,
        backend="auction",
        auction_config=AuctionConfig(rounds=8, candidates=0),
        drain_grace_ticks=40,
    )


def test_the_patched_working_set_is_the_full_classifications(monkeypatch):
    patches: list[tuple[str, int, int]] = []
    orig = VirtualNodeProvider._rescope_mirror_cache

    def checked(self, table, mc, changed, deleted, span):
        joins0, leaves0 = self.mirror_patched_joins, self.mirror_patched_leaves
        out = orig(self, table, mc, changed, deleted, span)
        if out is not None:
            _assert_same_working_set(self, table, *out)
            patches.append((self.partition, self.mirror_patched_joins - joins0,
                            self.mirror_patched_leaves - leaves0))
        return out

    monkeypatch.setattr(VirtualNodeProvider, "_rescope_mirror_cache", checked)
    h = SimHarness(_churn(), device="cpu")
    try:
        h.run_tick(0)
        h.run_tick(1)
        providers = dict(h.configurator.providers)
        full = {n: p.mirror_scans_full for n, p in providers.items()}
        for t in range(2, 14):
            h.run_tick(t)
        assert {n: p.mirror_scans_full for n, p in providers.items()} == full
    finally:
        h._cleanup()
    assert len(providers) == 2
    assert len(patches) >= 2 * 12
    for name in providers:
        mine = [p for p in patches if p[0] == name]
        assert sum(j for _, j, _ in mine) > 0, name
        assert sum(lv for _, _, lv in mine) > 0, name
        assert providers[name].mirror_patched_joins >= sum(j for _, j, _ in mine)


class _Client:
    """The simulated agent, recording the JobsInfo requests' cursors and
    failing the next ``fail_submits`` SubmitJobs calls as unavailable."""

    def __init__(self, inner):
        self._inner = inner
        self.fail_submits = 0
        self.queries: list[tuple[int, tuple]] = []

    def __getattr__(self, name):
        fn = getattr(self._inner, name)
        if name.startswith("SubmitJobs"):
            def submit(*a, **kw):
                if self.fail_submits:
                    self.fail_submits -= 1
                    raise RpcError(StatusCode.UNAVAILABLE, "agent busy")
                return fn(*a, **kw)
            return submit
        if name.startswith("JobsInfo"):
            def query(req, *a, **kw):
                self.queries.append((req.since_version, tuple(req.job_ids)))
                return fn(req, *a, **kw)
            return query
        return fn


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


def _pod(name: str) -> Pod:
    return Pod(
        meta=Meta(name=name),
        spec=PodSpec(
            role=PodRole.SIZECAR, partition="part0",
            node_name=partition_node_name("part0"),
            demand=JobDemand(partition="part0", script="#!/bin/sh\ntrue\n",
                             cpus_per_task=1, time_limit_s=1000, job_name=name),
        ),
    )


def _converged(n_pods: int = 4):
    """A provider whose pods run, with the job cursor past zero."""
    clock = _Clock()
    nodes = [SimNode(name=f"n{i}", cpus=16, memory_mb=32000) for i in range(4)]
    cluster = SimCluster(nodes, {"part0": tuple(n.name for n in nodes)}, clock=clock)
    client = _Client(SimWorkloadClient(cluster))
    store = ObjectStore()
    provider = VirtualNodeProvider(
        store, client, "part0", events=EventRecorder(), sync_workers=1,
        inventory_ttl=0.0, status_interval=3600.0, incremental=True,
    )
    for i in range(n_pods):
        store.create(_pod(f"bp{i}"))
    for _ in range(3):
        provider.sync()
    assert all(p.status.phase == PodPhase.RUNNING for p in store.list(Pod.KIND))
    assert provider._jobs_cursor > 0
    return store, client, provider


def test_a_transiently_failed_submit_is_retried_on_the_next_sync():
    store, client, provider = _converged()
    full = provider.mirror_scans_full
    store.create(_pod("late"))
    client.fail_submits = 1
    provider.sync()
    late = store.get(Pod.KIND, "late")
    assert tuple(late.status.job_ids) == ()
    rv = store.changes_since(Pod.KIND, 0)[0]
    provider.sync()  # nothing written since: the retry alone finds it
    assert store.changes_since(Pod.KIND, rv)[1] == ["late"]
    assert len(store.get(Pod.KIND, "late").status.job_ids) == 1
    provider.sync()
    assert store.get(Pod.KIND, "late").status.phase == PodPhase.RUNNING
    assert provider.mirror_scans_full == full
    assert provider.mirror_patched_joins > 0


def test_an_id_submitted_on_one_sync_is_queried_in_full_on_the_next():
    store, client, provider = _converged()
    store.create(_pod("late"))
    provider.sync()  # submits it: the pod joins the working set next sync
    (jid,) = store.get(Pod.KIND, "late").status.job_ids
    cursor = provider._jobs_cursor
    assert cursor > 0
    client.queries.clear()
    provider.sync()
    assert [(v, jid in ids) for v, ids in client.queries] == [(0, True)]
    client.queries.clear()
    provider.sync()  # applied now: the cursor scopes the chunk again
    assert len(client.queries) == 1
    since, ids = client.queries[0]
    assert since > 0 and jid in ids


class _Serialized:
    """The simulated agent behind one lock: it is not thread-safe, and the
    test below calls it from many threads."""

    def __init__(self, inner):
        self._inner = inner
        self.lock = threading.Lock()

    def __getattr__(self, name):
        fn = getattr(self._inner, name)
        if not callable(fn):
            return fn

        def call(*a, **kw):
            with self.lock:
                return fn(*a, **kw)

        return call


def test_concurrent_syncs_keep_one_working_set(monkeypatch):
    """The daemon syncs a provider from its ticker and from ``sync_now``
    at once. Syncs racing while pods arrive and finish leave a working
    set that a full classification agrees with, and every pod ends in
    its job's phase."""
    clock = _Clock()
    nodes = [SimNode(name=f"n{i}", cpus=64, memory_mb=256000) for i in range(4)]
    cluster = SimCluster(nodes, {"part0": tuple(n.name for n in nodes)}, clock=clock)
    client = _Serialized(SimWorkloadClient(cluster))
    store = ObjectStore()
    provider = VirtualNodeProvider(
        store, client, "part0", events=EventRecorder(), sync_workers=1,
        inventory_ttl=0.0, status_interval=3600.0, incremental=True,
    )
    for i in range(20):
        store.create(_pod(f"bp{i:03d}"))
    provider.sync()
    errors: list[BaseException] = []

    def syncing() -> None:
        try:
            for _ in range(25):
                provider.sync()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=syncing) for _ in range(2 * (os.cpu_count() or 2))]
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for i in range(20, 60):
            store.create(_pod(f"bp{i:03d}"))
            if i % 10 == 0:
                with client.lock:
                    clock.now += 400.0
                    cluster.step()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(before)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    checked: list[int] = []
    orig = VirtualNodeProvider._rescope_mirror_cache

    def checked_rescope(self, table, mc, changed, deleted, span):
        out = orig(self, table, mc, changed, deleted, span)
        if out is not None:
            _assert_same_working_set(self, table, *out)
            checked.append(1)
        return out

    monkeypatch.setattr(VirtualNodeProvider, "_rescope_mirror_cache", checked_rescope)
    for _ in range(3):
        provider.sync()
    clock.now += 5000.0
    cluster.step()
    for _ in range(3):
        provider.sync()
    assert checked
    pods = store.list(Pod.KIND)
    assert len(pods) == 60
    assert all(p.status.phase == PodPhase.SUCCEEDED for p in pods)
