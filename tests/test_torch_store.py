"""The port's object store against the JAX package's store tests.

Twins of ``tests/test_store_snapshots.py`` (frozen copy-on-read
snapshots, the (kind, node_name) index, the dirty-set, batched optimistic
writes, the owner cascade) run against ``slurm_bridge_tpu_torch.bridge``
(``tests/test_torch_twin_colstore.py`` runs ``tests/test_colstore.py``);
and one check that the same sequence of creates, mutates, binds and
deletes leaves both packages' stores in the same state.
"""

import dataclasses
import random

import numpy as np
import pytest

from slurm_bridge_tpu_torch.bridge.freeze import (
    FrozenDict,
    FrozenInstanceError,
    FrozenList,
    fast_replace,
    freeze,
    frozen_new,
    frozen_replace,
    is_frozen,
    thaw,
)
from slurm_bridge_tpu_torch.bridge.objects import (
    BridgeJob,
    BridgeJobSpec,
    Meta,
    Pod,
    PodRole,
    PodSpec,
    PodStatus,
)
from slurm_bridge_tpu_torch.bridge.store import (
    AlreadyExists,
    Conflict,
    NotFound,
    ObjectStore,
)
from slurm_bridge_tpu_torch.core.types import JobDemand, JobInfo, JobStatus


# =============================================== twins of test_store_snapshots


def _pod(name: str, node: str = "", owner: str = "") -> Pod:
    return Pod(
        meta=Meta(name=name, owner=owner, labels={"role": "sizecar"}),
        spec=PodSpec(
            role=PodRole.SIZECAR,
            partition="p0",
            node_name=node,
            demand=JobDemand(partition="p0", script="#!/bin/sh\ntrue\n"),
        ),
    )


def _job(name: str) -> BridgeJob:
    return BridgeJob(
        meta=Meta(name=name),
        spec=BridgeJobSpec(partition="p0", sbatch_script="#!/bin/sh\n"),
    )


# ------------------------------------------------------- freeze machinery


def test_freeze_blocks_every_mutation_surface():
    pod = _pod("f1")
    pod.status.job_infos = [JobInfo(id=1, state=JobStatus.RUNNING)]
    freeze(pod)
    assert is_frozen(pod) and is_frozen(pod.spec.demand)
    with pytest.raises(FrozenInstanceError):
        pod.spec.node_name = "n1"
    with pytest.raises(FrozenInstanceError):
        pod.meta.labels["x"] = "y"
    with pytest.raises(FrozenInstanceError):
        pod.meta.labels.pop("role")
    with pytest.raises(FrozenInstanceError):
        pod.status.job_infos.append(JobInfo())
    with pytest.raises(FrozenInstanceError):
        pod.status.job_infos[0].state = JobStatus.FAILED
    with pytest.raises(FrozenInstanceError):
        pod.spec.demand.cpus_per_task = 99
    # frozen containers still compare equal to their plain counterparts
    assert pod.meta.labels == {"role": "sizecar"}
    assert isinstance(pod.meta.labels, FrozenDict)
    assert isinstance(pod.status.job_infos, FrozenList)


def test_thaw_yields_plain_mutable_graph():
    pod = _pod("f2")
    pod.status.job_infos = [JobInfo(id=1)]
    freeze(pod)
    t = thaw(pod)
    assert not is_frozen(t) and not is_frozen(t.spec.demand)
    assert type(t.meta.labels) is dict
    assert type(t.status.job_infos) is list
    t.spec.node_name = "n1"
    t.meta.labels["x"] = "y"
    t.status.job_infos.append(JobInfo(id=2))
    # the frozen original is untouched
    assert pod.spec.node_name == "" and "x" not in pod.meta.labels


def test_dataclasses_replace_shares_frozen_children():
    pod = freeze(_pod("f3"))
    new = Pod(
        meta=dataclasses.replace(pod.meta),
        spec=dataclasses.replace(pod.spec, node_name="n9"),
        status=pod.status,
    )
    assert not is_frozen(new) and new.spec.demand is pod.spec.demand
    new.spec.placement_hint = ("a",)  # replacement is mutable pre-freeze


# ------------------------------------------------------- snapshot reads


def test_reads_share_one_frozen_snapshot_per_version():
    s = ObjectStore()
    s.create(_pod("p1"))
    a = s.get(Pod.KIND, "p1")
    b = s.get(Pod.KIND, "p1")
    assert a is b  # zero-copy: same stored object
    assert a in s.list(Pod.KIND)
    s.mutate(Pod.KIND, "p1", lambda p: setattr(p.spec, "node_name", "n1"))
    c = s.get(Pod.KIND, "p1")
    assert c is not a  # new version = new object; old snapshot intact
    assert a.spec.node_name == "" and c.spec.node_name == "n1"


def test_mutate_fn_gets_private_thawed_copy():
    s = ObjectStore()
    s.create(_pod("p1"))

    def bump(p: Pod):
        p.meta.annotations["k"] = "v"
        p.status.job_ids = (7,)

    s.mutate(Pod.KIND, "p1", bump)
    got = s.get(Pod.KIND, "p1")
    assert got.meta.annotations == {"k": "v"} and got.status.job_ids == (7,)


# ------------------------------------------------------- secondary index


def test_list_by_node_tracks_bind_and_unbind():
    s = ObjectStore()
    s.create(_pod("a", node=""))
    s.create(_pod("b", node="n1"))
    s.create(_pod("c", node="n1"))
    assert [p.name for p in s.list_by_node(Pod.KIND, "n1")] == ["b", "c"]
    assert [p.name for p in s.list_by_node(Pod.KIND, "")] == ["a"]
    assert s.list_by_node(Pod.KIND, "n2") == []
    # bind a -> n1, move c -> n2, delete b
    s.mutate(Pod.KIND, "a", lambda p: setattr(p.spec, "node_name", "n1"))
    s.mutate(Pod.KIND, "c", lambda p: setattr(p.spec, "node_name", "n2"))
    s.delete(Pod.KIND, "b")
    assert [p.name for p in s.list_by_node(Pod.KIND, "n1")] == ["a"]
    assert [p.name for p in s.list_by_node(Pod.KIND, "n2")] == ["c"]
    assert s.list_by_node(Pod.KIND, "") == []


def test_fuzzed_index_equivalence_with_filtered_list():
    """Property check: after arbitrary create/update/delete churn, the
    indexed read equals the old-style full-list filter for every node."""
    rng = np.random.default_rng(7)
    s = ObjectStore()
    nodes = ["", "n0", "n1", "n2", "n3"]
    alive: set[str] = set()
    for step in range(400):
        op = rng.integers(0, 3)
        name = f"pod-{rng.integers(0, 60)}"
        if op == 0:
            try:
                s.create(_pod(name, node=str(rng.choice(nodes))))
                alive.add(name)
            except Exception:
                pass
        elif op == 1 and name in alive:
            target = str(rng.choice(nodes))
            s.mutate(
                Pod.KIND, name, lambda p, t=target: setattr(p.spec, "node_name", t)
            )
        elif op == 2 and name in alive:
            s.delete(Pod.KIND, name)
            alive.discard(name)
    full = s.list(Pod.KIND)
    assert {p.name for p in full} == alive
    for node in nodes:
        expect = [p.name for p in full if p.spec.node_name == node]
        got = [p.name for p in s.list_by_node(Pod.KIND, node)]
        assert got == expect  # same objects, same (sorted) order


# ------------------------------------------------------- dirty-set


def test_changes_since_reports_changed_and_deleted():
    s = ObjectStore()
    rv0, changed, deleted = s.changes_since(Pod.KIND, 0)
    assert changed == [] and deleted == []
    s.create(_pod("a"))
    s.create(_pod("b"))
    rv1, changed, deleted = s.changes_since(Pod.KIND, rv0)
    assert changed == ["a", "b"] and deleted == []
    s.mutate(Pod.KIND, "a", lambda p: setattr(p.spec, "node_name", "n1"))
    s.delete(Pod.KIND, "b")
    rv2, changed, deleted = s.changes_since(Pod.KIND, rv1)
    assert changed == ["a"] and deleted == ["b"]
    # nothing moved since rv2
    rv3, changed, deleted = s.changes_since(Pod.KIND, rv2)
    assert rv3 == rv2 and changed == [] and deleted == []
    # a recreated name stops being a tombstone
    s.create(_pod("b"))
    _, changed, deleted = s.changes_since(Pod.KIND, rv2)
    assert changed == ["b"] and deleted == []


# ------------------------------------------------------- update_batch


def test_update_batch_applies_all_and_reports_conflicts_per_object():
    s = ObjectStore()
    s.create(_pod("a"))
    s.create(_pod("b"))
    s.create(_pod("c"))
    snaps = {p.name: p for p in s.list(Pod.KIND)}
    # someone else wins a write on b between our read and our batch
    s.mutate(Pod.KIND, "b", lambda p: setattr(p.status, "reason", "raced"))

    def bound(p: Pod, node: str) -> Pod:
        return Pod(
            meta=dataclasses.replace(p.meta),
            spec=dataclasses.replace(p.spec, node_name=node),
            status=p.status,
        )

    gone = bound(snaps["c"], "n1")
    s.delete(Pod.KIND, "c")
    results = s.update_batch(
        [bound(snaps["a"], "n1"), bound(snaps["b"], "n1"), gone]
    )
    assert isinstance(results[0], Pod)
    assert isinstance(results[1], Conflict)
    assert isinstance(results[2], NotFound)
    assert s.get(Pod.KIND, "a").spec.node_name == "n1"
    got_b = s.get(Pod.KIND, "b")
    assert got_b.spec.node_name == "" and got_b.status.reason == "raced"
    # the successful write landed in the index too
    assert [p.name for p in s.list_by_node(Pod.KIND, "n1")] == ["a"]


def test_update_batch_is_one_write_per_object_semantics():
    s = ObjectStore()
    s.create(_pod("a"))
    snap = s.get(Pod.KIND, "a")
    new = Pod(
        meta=dataclasses.replace(snap.meta),
        spec=dataclasses.replace(snap.spec, node_name="n1"),
        status=snap.status,
    )
    (res,) = s.update_batch([new])
    assert res.meta.resource_version > snap.meta.resource_version
    # the stored object is frozen — the batch took ownership
    with pytest.raises(FrozenInstanceError):
        res.spec.node_name = "n2"


# ------------------------------------------------------- cascade + order


def test_delete_cascade_is_transitive():
    """BridgeJob -> sizecar pod -> pod-owned object: grandchildren must
    not leak (the one-level cascade did exactly that)."""
    s = ObjectStore()
    s.create(_job("j1"))
    s.create(_pod("j1-sizecar", owner="j1"))
    s.create(_pod("j1-sizecar-shadow", owner="j1-sizecar"))
    s.create(_pod("j1-sizecar-shadow-leaf", owner="j1-sizecar-shadow"))
    s.create(_pod("unrelated"))
    s.delete(BridgeJob.KIND, "j1")
    assert s.try_get(Pod.KIND, "j1-sizecar") is None
    assert s.try_get(Pod.KIND, "j1-sizecar-shadow") is None
    assert s.try_get(Pod.KIND, "j1-sizecar-shadow-leaf") is None
    assert s.try_get(Pod.KIND, "unrelated") is not None


def test_owned_by_returns_name_sorted():
    s = ObjectStore()
    for name in ("z-pod", "a-pod", "m-pod"):
        s.create(_pod(name, owner="j1"))
    assert [p.name for p in s.owned_by(Pod.KIND, "j1")] == [
        "a-pod",
        "m-pod",
        "z-pod",
    ]


# ---- create_batch (PR-4) ----


def test_create_batch_commits_all_under_one_pass():
    s = ObjectStore()
    q = s.watch((Pod.KIND,))
    pods = [_pod(f"cb{i}") for i in range(3)]
    results = s.create_batch(pods)
    assert [r.meta.name for r in results] == ["cb0", "cb1", "cb2"]
    assert all(is_frozen(r) for r in results)
    # rv strictly increasing per item, exactly like N creates
    rvs = [r.meta.resource_version for r in results]
    assert rvs == sorted(rvs) and len(set(rvs)) == 3
    events = [q.get_nowait() for _ in range(3)]
    assert [(e.type, e.name) for e in events] == [
        ("ADDED", "cb0"), ("ADDED", "cb1"), ("ADDED", "cb2"),
    ]


def test_create_batch_per_item_already_exists():
    s = ObjectStore()
    s.create(_pod("dup"))
    results = s.create_batch([_pod("new0"), _pod("dup"), _pod("new1")])
    assert results[0].meta.name == "new0"
    assert isinstance(results[1], AlreadyExists)
    assert results[2].meta.name == "new1"
    # the failed item aborted nothing
    assert s.try_get(Pod.KIND, "new0") is not None
    assert s.try_get(Pod.KIND, "new1") is not None


def test_create_batch_maintains_node_index():
    s = ObjectStore()
    s.create_batch([_pod("ix0", node="vn-a"), _pod("ix1", node="vn-a")])
    assert [p.name for p in s.list_by_node(Pod.KIND, "vn-a")] == ["ix0", "ix1"]


# ---- fastpath constructors (PR-4) ----


def test_fast_replace_shares_children_and_stays_writable():
    s = ObjectStore()
    stored = s.create(_pod("fr0"))
    repl = fast_replace(
        stored, meta=fast_replace(stored.meta), status=PodStatus(phase="Running")
    )
    assert repl.spec is stored.spec  # structural sharing
    repl.meta.resource_version = stored.meta.resource_version  # writable copy
    updated = s.update(repl)
    assert updated.status.phase == "Running"
    assert s.get(Pod.KIND, "fr0").spec is stored.spec


def test_frozen_new_is_born_guarded():
    row = frozen_new(
        JobInfo,
        id=1, user_id="", name="x", exit_code="", state=JobStatus.RUNNING,
        submit_time=None, start_time=None, run_time_s=0, time_limit_s=0,
        working_dir="", std_out="", std_err="", partition="", node_list="",
        batch_host="", num_nodes=0, array_id="", reason="",
    )
    assert is_frozen(row)
    with pytest.raises(FrozenInstanceError):
        row.run_time_s = 99
    # equality with a normally-constructed twin holds (field-based eq)
    assert row == JobInfo(id=1, name="x", state=JobStatus.RUNNING)
    # freeze() short-circuits: same object back, untouched
    assert freeze(row) is row


def test_frozen_replace_shares_and_rejects_mutation():
    s = ObjectStore()
    stored = s.create(_pod("fz0"))
    status2 = frozen_replace(stored.status, phase="Running")
    assert is_frozen(status2)
    assert status2.job_infos is stored.status.job_infos
    with pytest.raises(FrozenInstanceError):
        status2.phase = "Failed"


# ================================================ port ≡ JAX package, same ops


def _norm(v):
    """A package-neutral value: dataclasses by class name and fields,
    enums by class name and value, containers as plain tuples."""
    import enum

    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,) + tuple(
            (f.name, _norm(getattr(v, f.name))) for f in dataclasses.fields(v)
        )
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.value)
    if isinstance(v, dict):
        return ("dict",) + tuple(sorted((k, _norm(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_norm(x) for x in v)
    return v


def _drive_store(pkg: str, seed: int):
    """One seeded sequence of creates, mutates, binds (columnar row
    writes and object batches), unschedulable marks and deletes against
    ``pkg``'s store; returns everything a reader can observe of it."""
    import importlib

    objs = importlib.import_module(f"{pkg}.bridge.objects")
    store_mod = importlib.import_module(f"{pkg}.bridge.store")
    types = importlib.import_module(f"{pkg}.core.types")
    colstore = importlib.import_module(f"{pkg}.bridge.colstore")
    freeze = importlib.import_module(f"{pkg}.bridge.freeze")
    rng = random.Random(seed)
    store = store_mod.ObjectStore()
    watch = store.watch((objs.Pod.KIND, objs.BridgeJob.KIND))
    marks = []
    names = [f"pod-{i}" for i in range(40)]
    store.create_batch([
        objs.Pod(
            meta=objs.Meta(name=n, uid=f"uid-{n}", owner=f"bj-{i % 4}" if i % 3 else "",
                           labels={"i": str(i)}),
            spec=objs.PodSpec(
                role=objs.PodRole.SIZECAR, partition=f"p{i % 3}",
                demand=types.JobDemand(partition=f"p{i % 3}", cpus_per_task=1 + i % 5,
                                       nodes=1 + i % 2),
            ),
        )
        for i, n in enumerate(names)
    ])
    for i in range(4):
        store.create(objs.BridgeJob(
            meta=objs.Meta(name=f"bj-{i}", uid=f"uid-bj-{i}"),
            spec=objs.BridgeJobSpec(partition=f"p{i % 3}", sbatch_script="#!/bin/sh\n"),
        ))
    table = store.table(objs.Pod.KIND)
    for step in range(30):
        live = [p.meta.name for p in store.list(objs.Pod.KIND)]
        op = rng.randrange(5)
        if op == 0 and live:  # a columnar bind, as the scheduler commits one
            pick = sorted(rng.sample(live, min(len(live), rng.randrange(1, 6))))
            rvs = np.asarray([store.get(objs.Pod.KIND, n).meta.resource_version
                              for n in pick], np.int64)
            hints = colstore.object_array([(f"node{rng.randrange(9)}",) for _ in pick])

            def writer(rws, sel, hints=hints):
                table.cols.hint[rws] = hints[sel]
                table.cols.reason[rws] = ""

            store.update_rows(objs.Pod.KIND, pick, rvs, writer, site="t.bind",
                              node_to=colstore.object_array([f"vn-{step % 3}"] * len(pick)))
        elif op == 1 and live:  # an unschedulable mark through update_batch
            pick = sorted(rng.sample(live, min(len(live), 3)))
            cur = [store.get(objs.Pod.KIND, n) for n in pick]
            store.update_batch([
                freeze.fast_replace(p, meta=freeze.fast_replace(p.meta),
                                    status=freeze.frozen_replace(p.status, reason=f"r{step}"))
                for p in cur
            ], site="t.mark")
        elif op == 2 and live:  # a mutate (preemption-style reset)
            name = rng.choice(live)

            def reset(p, step=step):
                p.meta.annotations["submit-generation"] = str(step)
                p.spec.node_name = ""
                p.spec.placement_hint = ()
                p.status.job_ids = (step,)
                p.status.phase = objs.PodPhase.RUNNING

            store.mutate(objs.Pod.KIND, name, reset, site="t.mutate")
        elif op == 3 and live:  # delete a pod, or a job and its pods
            jobs = [j.meta.name for j in store.list(objs.BridgeJob.KIND)]
            if jobs and rng.random() < 0.3:
                store.delete(objs.BridgeJob.KIND, rng.choice(jobs))
            else:
                store.delete(objs.Pod.KIND, rng.choice(live))
        else:
            marks.append(store.changes_since(objs.Pod.KIND, marks[-1][0] if marks else 0))
    events = []
    while True:
        try:
            ev = watch.get_nowait()
        except Exception:
            break
        events.append(tuple(ev))
    return {
        "pods": _norm(store.list(objs.Pod.KIND)),
        "jobs": _norm(store.list(objs.BridgeJob.KIND)),
        "by_node": {n: [p.meta.name for p in store.list_by_node(objs.Pod.KIND, n)]
                    for n in ("", "vn-0", "vn-1", "vn-2")},
        "marks": marks,
        "events": events,
        "commits": dict(store.commit_counts),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_ops_leave_both_packages_stores_equal(seed):
    port = _drive_store("slurm_bridge_tpu_torch", seed)
    ref = _drive_store("slurm_bridge_tpu", seed)
    for key in ref:
        assert port[key] == ref[key], key
