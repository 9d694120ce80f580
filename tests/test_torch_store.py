"""The port's object store against the JAX package's store tests.

Twins of ``tests/test_store_snapshots.py`` (frozen copy-on-read
snapshots, the (kind, node_name) index, the dirty-set, batched optimistic
writes, the owner cascade) and of ``tests/test_colstore.py`` (the
columnar tables observably identical to the object store) — all but the
submit-converter check, whose converters come with the vnode slice — run
against ``slurm_bridge_tpu_torch.bridge``; and one check that the same
sequence of creates, mutates, binds and deletes leaves both packages'
stores in the same state.
"""

import dataclasses
import random

import numpy as np
import pytest

from slurm_bridge_tpu_torch.bridge.colstore import SegmentHeap, object_array, object_full
from slurm_bridge_tpu_torch.bridge.columns import (
    CR_STATE_OF_PHASE,
    DEFAULT_COLUMNAR,
    JOBSTATUS_BY_CODE,
    PHASE_CODE,
    PHASE_OF_SINGLE_STATE,
    PHASE_STRS,
    STATE_STRS,
)
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
    ContainerStatus,
    JobState,
    Meta,
    Pod,
    PodPhase,
    PodRole,
    PodSpec,
    PodStatus,
    SubjobStatus,
)
from slurm_bridge_tpu_torch.bridge.statusmap import job_state_for_pod_phase, pod_phase_for
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


# ==================================================== twins of test_colstore


SCRIPT = "#!/bin/sh\ntrue\n"


def _cdemand(rng: random.Random | None = None) -> JobDemand:
    r = rng or random.Random(0)
    return JobDemand(
        partition=f"p{r.randrange(3)}",
        script=SCRIPT,
        cpus_per_task=r.randrange(1, 8),
        ntasks=r.randrange(1, 4),
        nodes=r.randrange(1, 3),
    )


def _cinfo(rng: random.Random, jid: int) -> JobInfo:
    from datetime import datetime

    state = rng.choice(list(JobStatus))
    return JobInfo(
        id=jid,
        state=state,
        name=f"job-{jid}",
        user_id=f"u{rng.randrange(4)}",
        exit_code=rng.choice(["", "0:0", "1:0"]),
        submit_time=rng.choice(
            [None, datetime(2026, 1, 1, 12, 0, rng.randrange(60))]
        ),
        start_time=rng.choice(
            [None, datetime(2026, 1, 1, 12, 30, rng.randrange(60))]
        ),
        run_time_s=rng.randrange(0, 4000),
        time_limit_s=3600,
        std_out=f"/o/{jid}",
        std_err=f"/e/{jid}",
        partition=f"p{rng.randrange(3)}",
        node_list=f"n{rng.randrange(10)}",
        batch_host=f"n{rng.randrange(10)}",
        num_nodes=rng.randrange(1, 4),
        array_id=rng.choice(["", f"{jid}_0"]),
        reason=rng.choice(["", "Resources"]),
    )


def _cpod(rng: random.Random, i: int) -> Pod:
    n_infos = rng.choice([0, 1, 1, 1, 2])
    infos = [_cinfo(rng, 9000 + i * 10 + k) for k in range(n_infos)]
    return Pod(
        meta=Meta(
            name=f"pod-{i}",
            uid=f"uid-pod-{i}",
            owner=rng.choice(["", f"bj-{i % 5}"]),
            labels={"role": "sizecar", "i": str(i)},
            annotations={} if rng.random() < 0.5 else {"k": f"v{i}"},
        ),
        spec=PodSpec(
            role=rng.choice([PodRole.SIZECAR, PodRole.WORKER]),
            partition=f"p{i % 3}",
            node_name=rng.choice(["", f"vn-p{i % 3}"]),
            placement_hint=rng.choice([(), (f"n{i}",)]),
            demand=_cdemand(rng) if rng.random() < 0.8 else None,
        ),
        status=PodStatus(
            phase=rng.choice(PHASE_STRS),
            reason=rng.choice(["", "Unschedulable: insufficient capacity"]),
            job_ids=tuple(inf.id for inf in infos),
            job_infos=infos,
            containers=[
                ContainerStatus(name=f"job-{i}", state="running")
            ]
            if rng.random() < 0.3
            else [],
        ),
    )


def _cjob(rng: random.Random, i: int) -> BridgeJob:
    job = BridgeJob(
        meta=Meta(name=f"bj-{i}", uid=f"uid-bj-{i}", labels={"tenant": f"t{i % 2}"}),
        spec=BridgeJobSpec(partition=f"p{i % 3}", sbatch_script=SCRIPT),
    )
    job.status.state = rng.choice(STATE_STRS)
    job.status.reason = rng.choice(["", "failed: boom"])
    if rng.random() < 0.5:
        job.status.subjobs = {
            "0": SubjobStatus(
                id=5000 + i,
                state=rng.choice(list(JobStatus)),
                run_time_s=rng.randrange(100),
                submit_time="2026-01-01T12:00:00",
            )
        }
    return job


def _assert_stores_equal(cs: ObjectStore, os_: ObjectStore) -> None:
    for kind in (Pod.KIND, BridgeJob.KIND):
        a, b = cs.list(kind), os_.list(kind)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x == y, f"{kind}/{x.meta.name} diverged"
            assert x.meta.resource_version == y.meta.resource_version
            assert is_frozen(x)


def _drain(q) -> list:
    out = []
    while True:
        try:
            out.append(q.get_nowait())
        except Exception:
            break
    return out


# ------------------------------------------------- lookup-table oracles


def test_phase_lookup_tables_in_sync_with_statusmap():
    for code, status in enumerate(JOBSTATUS_BY_CODE):
        assert PHASE_STRS[PHASE_OF_SINGLE_STATE[code]] == pod_phase_for([status])
    for pcode, phase in enumerate(PHASE_STRS):
        assert STATE_STRS[CR_STATE_OF_PHASE[pcode]] == job_state_for_pod_phase(phase)


# ------------------------------------------------- fuzzed equivalence


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_fuzzed_columnar_equals_oracle(seed):
    """The same randomized op sequence through the columnar store and
    the frozen-object oracle must be observably identical: snapshots,
    resource versions, watch events, dirty sets, node-index lists."""
    rng = random.Random(seed)
    build_rng_a, build_rng_b = random.Random(seed + 100), random.Random(seed + 100)
    cs = ObjectStore()  # columnar for Pod + BridgeJob (the default)
    os_ = ObjectStore(columnar=())  # the oracle
    assert set(DEFAULT_COLUMNAR) == {Pod.KIND, BridgeJob.KIND}
    wq_c = cs.watch((Pod.KIND, BridgeJob.KIND))
    wq_o = os_.watch((Pod.KIND, BridgeJob.KIND))
    live: list[tuple[str, str]] = []
    marks_c = {Pod.KIND: 0, BridgeJob.KIND: 0}
    marks_o = {Pod.KIND: 0, BridgeJob.KIND: 0}
    i = 0

    def op_create():
        nonlocal i
        if rng.random() < 0.6:
            a, b = _cpod(build_rng_a, i), _cpod(build_rng_b, i)
        else:
            a, b = _cjob(build_rng_a, i), _cjob(build_rng_b, i)
        i += 1
        ra = cs.create(a, site="fuzz.create")
        rb = os_.create(b, site="fuzz.create")
        assert ra == rb
        live.append((type(a).KIND, a.meta.name))

    def op_create_dup():
        if not live:
            return
        kind, name = rng.choice(live)
        obj_c = cs.get(kind, name)
        with pytest.raises(AlreadyExists):
            cs.create(dataclasses.replace(obj_c, meta=dataclasses.replace(obj_c.meta)))
        obj_o = os_.get(kind, name)
        with pytest.raises(AlreadyExists):
            os_.create(dataclasses.replace(obj_o, meta=dataclasses.replace(obj_o.meta)))

    def op_mutate():
        if not live:
            return
        kind, name = rng.choice(live)
        reason = f"r{rng.randrange(100)}"
        if kind == Pod.KIND:
            def fn(p):
                p.status.reason = reason
                p.status.phase = PodPhase.RUNNING
        else:
            def fn(j):
                j.status.reason = reason
        cs.mutate(kind, name, fn, site="fuzz.mutate")
        os_.mutate(kind, name, fn, site="fuzz.mutate")

    def op_update_batch():
        if not live:
            return
        picks = sorted(set(rng.sample(live, min(len(live), rng.randrange(1, 6)))))
        for store in (cs, os_):
            objs = []
            for kind, name in picks:
                cur = store.get(kind, name)
                if kind == Pod.KIND:
                    objs.append(fast_replace(
                        cur,
                        meta=fast_replace(cur.meta),
                        status=frozen_replace(cur.status, reason="batched"),
                    ))
                else:
                    objs.append(fast_replace(
                        cur,
                        meta=fast_replace(cur.meta),
                        status=frozen_replace(cur.status, reason="batched"),
                    ))
            results = store.update_batch(objs, site="fuzz.batch")
            assert not any(isinstance(r, Exception) for r in results)

    def op_conflict():
        if not live:
            return
        kind, name = rng.choice(live)
        for store in (cs, os_):
            cur = store.get(kind, name)
            stale = fast_replace(
                cur,
                meta=fast_replace(cur.meta),
                status=frozen_replace(cur.status, reason="stale-write"),
            )
            store.mutate(kind, name, lambda o: None, site="fuzz.touch")
            with pytest.raises(Conflict):
                store.update(stale, site="fuzz.conflict")

    def op_delete():
        if not live:
            return
        kind, name = rng.choice(live)
        # cascade: deleting a BridgeJob owner removes owned pods in both
        cs.delete(kind, name)
        os_.delete(kind, name)
        deleted_c = {(kind, name)}
        live[:] = [
            (k, n)
            for (k, n) in live
            if (k, n) not in deleted_c and cs.try_get(k, n) is not None
        ]

    def op_mark():
        nonlocal marks_c, marks_o
        kind = rng.choice((Pod.KIND, BridgeJob.KIND))
        rv_c, ch_c, del_c = cs.changes_since(kind, marks_c[kind])
        rv_o, ch_o, del_o = os_.changes_since(kind, marks_o[kind])
        assert sorted(ch_c) == sorted(ch_o)
        assert sorted(del_c) == sorted(del_o)
        marks_c[kind], marks_o[kind] = rv_c, rv_o

    def op_list_by_node():
        nodes = {""} | {
            p.spec.node_name for p in cs.list(Pod.KIND) if p.spec.node_name
        }
        for node in sorted(nodes):
            assert cs.list_by_node(Pod.KIND, node) == os_.list_by_node(Pod.KIND, node)

    ops = [
        (op_create, 5), (op_create_dup, 1), (op_mutate, 5),
        (op_update_batch, 3), (op_conflict, 1), (op_delete, 2),
        (op_mark, 2), (op_list_by_node, 1),
    ]
    weighted = [f for f, w in ops for _ in range(w)]
    for _ in range(60):
        rng.choice(weighted)()
        _assert_stores_equal(cs, os_)
    assert [tuple(e) for e in _drain(wq_c)] == [tuple(e) for e in _drain(wq_o)]
    # commit attribution followed the ops identically on both stores
    assert cs.commit_counts == os_.commit_counts


@pytest.mark.parametrize("seed", [0, 2])
def test_update_rows_equals_per_object_updates(seed):
    """The row-write hot path vs the same logical writes applied
    per-object on the oracle: identical snapshots, rvs, watch events."""
    rng = random.Random(seed)
    build_a, build_b = random.Random(seed), random.Random(seed)
    cs, os_ = ObjectStore(), ObjectStore(columnar=())
    pods_c = [_cpod(build_a, i) for i in range(30)]
    pods_o = [_cpod(build_b, i) for i in range(30)]
    for a, b in zip(pods_c, pods_o):
        cs.create(a)
        os_.create(b)
    wq_c, wq_o = cs.watch((Pod.KIND,)), os_.watch((Pod.KIND,))
    table = cs.table(Pod.KIND)
    c = table.cols
    for _ in range(8):
        picked = sorted(rng.sample(range(30), rng.randrange(1, 10)))
        names = [f"pod-{i}" for i in picked]
        cur_rv = np.asarray(
            [cs.get(Pod.KIND, n).meta.resource_version for n in names], np.int64
        )
        reasons = object_array([f"vec-{rng.randrange(5)}" for _ in names])
        phases = np.asarray(
            [rng.randrange(len(PHASE_STRS)) for _ in names], np.int8
        )

        def writer(rws, sel):
            c.reason[rws] = reasons[sel]
            c.phase[rws] = phases[sel]

        res = cs.update_rows(
            Pod.KIND, names, cur_rv, writer, site="fuzz.rows"
        )
        assert (res > 0).all()
        for k, n in enumerate(names):
            def apply(p, k=k):
                return fast_replace(
                    p,
                    meta=fast_replace(p.meta),
                    status=frozen_replace(
                        p.status,
                        reason=reasons[k],
                        phase=PHASE_STRS[phases[k]],
                    ),
                )
            os_.replace_update(Pod.KIND, n, apply, site="fuzz.rows")
        _assert_stores_equal(cs, os_)
    assert [tuple(e) for e in _drain(wq_c)] == [tuple(e) for e in _drain(wq_o)]
    assert cs.commit_counts == os_.commit_counts
    # NotFound / Conflict encodings
    res = cs.update_rows(
        Pod.KIND, ["pod-0", "ghost"], np.asarray([0, 1], np.int64),
        lambda r, s: None, site="fuzz.rows",
    )
    assert res[0] == -1 and res[1] == 0


def test_update_rows_node_to_moves_index():
    cs = ObjectStore()
    cs.create(_cpod(random.Random(1), 0))
    pod = cs.get(Pod.KIND, "pod-0")
    start_node = pod.spec.node_name
    table = cs.table(Pod.KIND)
    target = "vn-moved"
    res = cs.update_rows(
        Pod.KIND, ["pod-0"],
        np.asarray([pod.meta.resource_version], np.int64),
        lambda r, s: None,
        site="fuzz.move",
        node_to=object_array([target]),
    )
    assert res[0] > 0
    assert [p.meta.name for p in cs.list_by_node(Pod.KIND, target)] == ["pod-0"]
    assert all(
        p.meta.name != "pod-0" for p in cs.list_by_node(Pod.KIND, start_node)
    )
    assert cs.get(Pod.KIND, "pod-0").spec.node_name == target


def test_create_rows_matches_create_batch():
    cs, os_ = ObjectStore(), ObjectStore(columnar=())
    table = cs.table(Pod.KIND)
    c = table.cols
    names = [f"cr-{i}" for i in range(6)] + ["cr-2"]  # one duplicate

    def builder(rows, sel):
        spos = sel.tolist()
        n = len(spos)
        c.name[rows] = object_array([names[p] for p in spos])
        c.uid[rows] = object_array([f"uid-{p}" for p in spos])
        c.labels[rows] = object_full(n, {})
        c.ann[rows] = object_full(n, {})
        c.owner[rows] = object_full(n, "")
        c.deleted[rows] = False
        c.role[rows] = object_full(n, PodRole.WORKER)
        c.partition[rows] = object_full(n, "p0")
        c.demand[rows] = object_full(n, None)
        c.node[rows] = object_full(n, "vn-p0")
        c.hint[rows] = object_full(n, ())
        c.phase[rows] = PHASE_CODE[PodPhase.PENDING]
        c.reason[rows] = object_full(n, "")
        c.job_ids[rows] = object_full(n, ())
        c.njobs[rows] = 0
        c.istart[rows] = 0
        c.ilen[rows] = 0
        c.cstart[rows] = 0
        c.clen[rows] = 0

    res = cs.create_rows(Pod.KIND, names, builder, site="fuzz.create_rows")
    assert (res[:6] > 0).all() and res[6] == 0  # duplicate skipped
    for i in range(6):
        obj = [
            Pod(
                meta=Meta(name=f"cr-{i}", uid=f"uid-{i}"),
                spec=PodSpec(
                    role=PodRole.WORKER, partition="p0", node_name="vn-p0"
                ),
            )
        ][0]
        os_.create(obj, site="fuzz.create_rows")
    a, b = cs.list(Pod.KIND), os_.list(Pod.KIND)
    assert [p.meta.name for p in a] == [p.meta.name for p in b]
    for x, y in zip(a, b):
        assert x.spec == y.spec and x.status == y.status
    assert [p.meta.name for p in cs.list_by_node(Pod.KIND, "vn-p0")] == [
        f"cr-{i}" for i in range(6)
    ]


# ------------------------------------------------- view laziness


def test_writes_build_zero_views_until_read():
    cs = ObjectStore()
    rng = random.Random(3)
    for i in range(20):
        cs.create(_cpod(rng, i))
    table = cs.table(Pod.KIND)
    base = table.view_builds
    c = table.cols
    names = [f"pod-{i}" for i in range(20)]
    rvs = np.asarray([int(c.rv[table.row_of[n]]) for n in names], np.int64)

    def writer(rws, sel):
        c.reason[rws] = "w"

    cs.update_rows(Pod.KIND, names, rvs, writer, site="fuzz.lazy")
    assert table.view_builds == base  # rows written, zero views built
    assert cs.rows_written_total() >= 20
    got = cs.get(Pod.KIND, "pod-3")
    assert got.status.reason == "w"
    assert table.view_builds == base + 1  # only the read materialized
    assert cs.get(Pod.KIND, "pod-3") is got  # cached per rv


def test_view_cache_invalidates_on_row_write():
    cs = ObjectStore()
    cs.create(_cpod(random.Random(5), 0))
    a = cs.get(Pod.KIND, "pod-0")
    table = cs.table(Pod.KIND)
    c = table.cols

    def writer(rws, sel):
        c.reason[rws] = "fresh"

    cs.update_rows(
        Pod.KIND, ["pod-0"],
        np.asarray([a.meta.resource_version], np.int64),
        writer, site="fuzz.inval",
    )
    b = cs.get(Pod.KIND, "pod-0")
    assert b is not a
    assert b.status.reason == "fresh"
    assert b.meta.resource_version == a.meta.resource_version + 1
    # the stale snapshot the caller still holds is untouched (frozen)
    assert a.status.reason != "fresh"


def test_segment_heap_compaction_preserves_rows():
    h = SegmentHeap({"v": "i8"}, cap=4)
    h.COMPACT_FLOOR = 0
    segs = []
    for tag in range(6):
        start = h.alloc(3)
        h.v[start : start + 3] = tag
        segs.append((tag, start, 3))
    # retire the even tags' segments
    live = [s for s in segs if s[0] in (1, 4)]
    h.retire(12)
    assert h.wasteful
    moved = h.compact([(t, s, ln) for t, s, ln in live])
    assert [t for t, _ in moved] == [1, 4]
    for (tag, pos), (_, _, ln) in zip(moved, live):
        assert (h.v[pos : pos + ln] == tag).all()
    assert h.n == 6 and h.dead == 0


def test_owner_cascade_crosses_columnar_and_object_kinds():
    cs = ObjectStore()
    job = _cjob(random.Random(7), 0)
    cs.create(job)
    pod = _cpod(random.Random(7), 1)
    pod = dataclasses.replace(
        pod, meta=dataclasses.replace(pod.meta, owner=job.meta.name)
    )
    cs.create(pod)
    cs.delete(BridgeJob.KIND, job.meta.name)
    assert cs.try_get(Pod.KIND, pod.meta.name) is None
    assert cs.try_get(BridgeJob.KIND, job.meta.name) is None


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
