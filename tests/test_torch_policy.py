"""The port's placement policy against the JAX package's policy tests.

Twins of the ``tests/test_policy.py`` cases that need neither the
simulator nor store persistence — class resolution, DRF fair-share
ordering, effective-priority encoding, the preemption-pool filter, the
backfill pass and its guard fuzz, the dirty-gated fair-share save — run
against ``slurm_bridge_tpu_torch.policy``; and a twin of
``tests/test_preemption.py``'s retried preemption cancel, raising the
port's own ``RpcError``.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from slurm_bridge_tpu_torch.core.types import JobDemand
from slurm_bridge_tpu_torch.policy import (
    CLASS_LABEL,
    TENANT_LABEL,
    ClassTable,
    FairShare,
    PlacementPolicy,
    PolicyConfig,
    PriorityClass,
    jain_index,
)
from slurm_bridge_tpu_torch.solver.snapshot import ClusterSnapshot, JobBatch, Placement

# ------------------------------------------------------------- classes


def test_class_table_resolution_and_default():
    table = ClassTable()
    assert table.resolve({CLASS_LABEL: "production"}).name == "production"
    assert table.resolve({}).name == "batch"
    assert table.resolve(None).name == "batch"
    # unknown class degrades to the default (and warns once)
    assert table.resolve({CLASS_LABEL: "no-such"}).name == "batch"


def test_class_table_ranks_ascend_with_priority():
    table = ClassTable()
    ranks = [table.rank_of(c) for c in table.classes]
    prios = [c.priority for c in table.classes]
    assert ranks == sorted(ranks)
    assert prios == sorted(prios)
    assert table.rank_of(table.by_name["system"]) == len(table) - 1


def test_class_table_rejects_bad_config():
    with pytest.raises(ValueError):
        ClassTable(())
    with pytest.raises(ValueError):
        ClassTable(default="nope")


# ----------------------------------------------------------- fair share


def test_jain_index_bounds():
    assert jain_index([]) == 1.0
    assert jain_index([5.0, 5.0, 5.0]) == pytest.approx(1.0)
    assert jain_index([1.0, 0.0, 0.0, 0.0]) == pytest.approx(0.25)


def test_drf_order_interleaves_tenants():
    fair = FairShare()
    # jobs: (tenant, dominant share, spec priority, name) — tenant a's
    # jobs all outrank tenant b's on priority, but DRF alternates them
    jobs = [
        ("a", 0.1, 100.0, "a0"),
        ("a", 0.1, 99.0, "a1"),
        ("b", 0.1, 1.0, "b0"),
        ("b", 0.1, 0.0, "b1"),
    ]
    order = fair.order(jobs)
    tenants = [jobs[i][0] for i in order]
    assert tenants == ["a", "b", "a", "b"]
    # within a tenant, priority desc
    assert [jobs[i][3] for i in order if jobs[i][0] == "a"] == ["a0", "a1"]


def test_drf_order_honors_weights_and_usage():
    fair = FairShare({"heavy": 3.0})
    jobs = [(t, 1.0, 0.0, f"{t}{i}") for t in ("heavy", "light") for i in range(3)]
    order = fair.order(jobs)
    # weight 3 ⇒ heavy admits ~3 jobs per light job at equal shares
    first_four = [jobs[i][0] for i in order[:4]]
    assert first_four.count("heavy") == 3
    # accumulated usage pushes a tenant back
    fair2 = FairShare()
    fair2.charge("a", 10.0)
    order2 = fair2.order([("a", 1.0, 0.0, "a0"), ("b", 1.0, 0.0, "b0")])
    assert [jobs_i for jobs_i in order2] == [1, 0]  # b first


# ------------------------------------------------- prepare / preemption


def _pod(name, *, cls="", tenant="", prio=0, cpus=4, nodes=1):
    labels = {}
    if cls:
        labels[CLASS_LABEL] = cls
    if tenant:
        labels[TENANT_LABEL] = tenant
    return SimpleNamespace(
        name=name,
        labels=labels,
        demand=JobDemand(
            partition="p0", cpus_per_task=cpus, ntasks=1, nodes=nodes,
            mem_per_cpu_mb=1024, priority=prio,
        ),
        partition="p0",
    )


def _nodes(n=4, cpus=64):
    return [
        SimpleNamespace(cpus=cpus, memory_mb=cpus * 1024, gpus=0)
        for _ in range(n)
    ]


def test_prepare_class_dominance_and_float32_exact():
    policy = PlacementPolicy(PolicyConfig())
    policy.begin_tick(_nodes())
    pending = [
        _pod("low", cls="best-effort", prio=99),
        _pod("prod", cls="production", prio=1),
        _pod("batch", cls="batch", prio=50),
    ]
    ordered, pool, eff = policy.prepare(pending, [])
    assert [p.name for p in ordered] == ["prod", "batch", "low"]
    assert eff == sorted(eff, reverse=True)
    # the solver stores priorities as float32: every effective priority
    # must survive the cast exactly, or admission order silently drifts
    assert all(float(np.float32(e)) == e for e in eff)


def test_prepare_never_pools_equal_or_higher_class():
    policy = PlacementPolicy(PolicyConfig())
    policy.begin_tick(_nodes())
    pending = [_pod("newcomer", cls="batch", prio=100)]
    incumbents = [
        _pod("inc-batch", cls="batch", prio=0),          # equal class
        _pod("inc-prod", cls="production", prio=0),      # higher class
        _pod("inc-be", cls="best-effort", prio=0),       # strictly lower
    ]
    ordered, pool, eff = policy.prepare(pending, incumbents)
    assert [p.name for p in pool] == ["inc-be"]
    # the pool incumbent's effective priority tops its band: the same-
    # class pending can never outbid it, the higher class always does
    inc_eff = eff[len(ordered):]
    assert inc_eff and all(e < min(eff[:1]) for e in inc_eff)


def test_prepare_pool_is_partition_aware():
    """The churn budget must go to incumbents the pending work can
    actually use: an incumbent whose partition has no higher-class
    pending stays out of the pool, however weak it is."""
    policy = PlacementPolicy(PolicyConfig())
    policy.begin_tick(_nodes())
    pending = [_pod("gang", cls="production", prio=0)]  # partition p0
    inc_same = _pod("inc-p0", cls="batch", prio=0)
    inc_other = _pod("inc-p1", cls="best-effort", prio=0)
    inc_other.partition = "p1"
    inc_other.demand = JobDemand(
        partition="p1", cpus_per_task=4, ntasks=1, nodes=1,
        mem_per_cpu_mb=1024, priority=0,
    )
    _, pool, _ = policy.prepare(pending, [inc_other, inc_same])
    assert [p.name for p in pool] == ["inc-p0"]


def test_prepare_pool_respects_preemptible_flag_and_churn_bound():
    policy = PlacementPolicy(PolicyConfig(max_preemptions_per_tick=2))
    policy.begin_tick(_nodes())
    pending = [_pod("p", cls="system", prio=0)]
    incumbents = [
        _pod(f"inc{i}", cls="batch", prio=i) for i in range(5)
    ] + [_pod("inc-prod", cls="production", prio=0)]  # non-preemptible
    _, pool, _ = policy.prepare(pending, incumbents)
    assert len(pool) == 2  # churn bound
    assert all(p.name.startswith("inc") and "prod" not in p.name for p in pool)
    # weakest first: lowest spec priority joins the pool first
    assert [p.name for p in pool] == ["inc0", "inc1"]
    assert policy.pool_excluded_last == 4


def test_prepare_fair_share_orders_within_class_by_tenant():
    policy = PlacementPolicy(PolicyConfig())
    policy.begin_tick(_nodes())
    pending = [
        _pod("a0", tenant="a", prio=100),
        _pod("a1", tenant="a", prio=99),
        _pod("b0", tenant="b", prio=1),
        _pod("b1", tenant="b", prio=0),
    ]
    ordered, _, _ = policy.prepare(pending, [])
    assert [p.name for p in ordered] == ["a0", "b0", "a1", "b1"]
    # charging admitted work moves the tenant back next tick
    policy.note_admitted([0, 2])  # a0 and a1's slots? indices into order
    ordered2, _, _ = policy.prepare(pending, [])
    assert ordered2[0].name == "b0"


# -------------------------------------------------------------- backfill


def _mini_world(free_rows, batch_rows, placed=None):
    """A snapshot/batch/placement triple for backfill unit tests.

    ``free_rows``: per-node [cpu, mem, gpu] free AFTER the main solve.
    ``batch_rows``: (job, gang, cpu, placed) one shard per entry, all in
    partition 0 with no feature requirements.
    """
    free = np.asarray(free_rows, np.float32)
    n = free.shape[0]
    snap = ClusterSnapshot(
        node_names=[f"n{i}" for i in range(n)],
        capacity=free.copy(),
        free=free.copy(),
        partition_of=np.zeros(n, np.int32),
        features=np.zeros(n, np.uint32),
        partition_codes={"p0": 0},
        feature_codes={},
    )
    dem = np.asarray(
        [[c, c * 1024.0, 0.0] for _, _, c, _ in batch_rows], np.float32
    )
    batch = JobBatch(
        demand=dem,
        partition_of=np.zeros(len(batch_rows), np.int32),
        req_features=np.zeros(len(batch_rows), np.uint32),
        priority=np.zeros(len(batch_rows), np.float32),
        gang_id=np.asarray([g for _, g, _, _ in batch_rows], np.int32),
        job_of=np.asarray([j for j, _, _, _ in batch_rows], np.int32),
    )
    placement = Placement(
        node_of=np.full(len(batch_rows), -1, np.int32),
        placed=np.asarray([p for _, _, _, p in batch_rows], bool),
        free_after=free.copy(),
    )
    return snap, batch, placement


def test_backfill_fills_holes_tightest_fit():
    snap, batch, placement = _mini_world(
        free_rows=[[8, 8 * 1024, 0], [4, 4 * 1024, 0]],
        batch_rows=[(0, 0, 4.0, False)],  # one unplaced single, 4 cpus
    )
    policy = PlacementPolicy(PolicyConfig())
    out = policy.backfill(snap, batch, placement, n_pending=1)
    # tightest fit: the 4-cpu hole, not the 8-cpu one
    assert out == [(0, 1)]
    assert policy.backfill_binds_total == 1


def test_backfill_never_delays_a_feasible_gang():
    # a 2-shard production gang is feasible on exactly nodes {0, 1}; a
    # best-effort single fits both too — taking either would strand the
    # gang, so the single must NOT be backfilled
    snap, batch, placement = _mini_world(
        free_rows=[[4, 4 * 1024, 0], [4, 4 * 1024, 0]],
        batch_rows=[
            (0, 0, 4.0, False),  # the single (job 0)
            (1, 1, 4.0, False),  # gang shard (job 1)
            (1, 1, 4.0, False),
        ],
    )
    policy = PlacementPolicy(PolicyConfig())
    # job 1 = higher class than job 0: prepare() normally records the
    # ranks; stub them directly for the unit test
    policy._tick_jobs = [
        ("", 0.1, 0),  # job 0: best-effort rank
        ("", 0.1, 2),  # job 1: production rank
    ]
    out = policy.backfill(snap, batch, placement, n_pending=2)
    # the GANG gets the nodes (all-or-nothing), the single is refused
    placed_rows = sorted(r for r, _ in out)
    assert placed_rows == [1, 2]


def test_backfill_gang_all_or_nothing_rollback():
    # gang of 2 but only ONE feasible node: nothing may be taken
    snap, batch, placement = _mini_world(
        free_rows=[[4, 4 * 1024, 0], [1, 1024, 0]],
        batch_rows=[(0, 0, 4.0, False), (0, 0, 4.0, False)],
    )
    policy = PlacementPolicy(PolicyConfig())
    out = policy.backfill(snap, batch, placement, n_pending=1)
    assert out == []
    # free_after untouched by the rolled-back attempt
    assert placement.free_after[0][0] == 4.0


def test_backfill_guard_fuzz_never_oversubscribes_or_strands():
    """Property fuzz: whatever backfill assigns, (a) no node ends over
    its free capacity and (b) every gang that was feasible before the
    pass — and was not itself placed — is still feasible after it,
    UNLESS a strictly higher-class candidate took its capacity (the
    guard protects equal-or-higher-class gangs only; higher-priority
    work out-packing a lower class is the policy working as designed)."""
    rng = np.random.default_rng(9)
    policy = PlacementPolicy(PolicyConfig())
    for _ in range(25):
        n = int(rng.integers(3, 10))
        free = np.stack(
            [
                rng.integers(0, 16, n).astype(np.float32),
                rng.integers(0, 16, n).astype(np.float32) * 1024,
                np.zeros(n, np.float32),
            ],
            axis=1,
        )
        rows = []
        job = 0
        for _ in range(int(rng.integers(1, 8))):
            size = int(rng.choice([1, 1, 2, 3]))
            cpu = float(rng.integers(1, 8))
            for _ in range(size):
                rows.append((job, job, cpu, False))
            job += 1
        snap, batch, placement = _mini_world(free.tolist(), rows)
        policy._tick_jobs = [
            ("", 0.1, int(rng.integers(0, 3))) for _ in range(job)
        ]

        def gang_feasible(free_now):
            ok = {}
            for g in set(batch.gang_id.tolist()):
                rws = np.nonzero(batch.gang_id == g)[0]
                if len(rws) < 2:
                    continue
                d = batch.demand[rws[0]]
                ok[g] = int(((free_now >= d).all(axis=1)).sum()) >= len(rws)
            return ok

        before = gang_feasible(placement.free_after)
        out = policy.backfill(snap, batch, placement, n_pending=job)
        free_now = placement.free_after.copy()
        for r, nd in out:
            free_now[nd] -= batch.demand[r]
        assert (free_now >= -1e-6).all(), "backfill oversubscribed a node"
        placed_gangs = {int(batch.gang_id[r]) for r, _ in out}
        max_placed_rank = max(
            (policy._tick_jobs[g][2] for g in placed_gangs), default=-1
        )
        after = gang_feasible(free_now)
        for g, was in before.items():
            if was and g not in placed_gangs:
                g_rank = policy._tick_jobs[g][2]
                if max_placed_rank <= g_rank:
                    assert after[g], f"backfill stranded feasible gang {g}"


# ------------------------------------------------------ fair-share ledger


def test_fairshare_save_is_dirty_gated():
    """A tick that admitted nothing writes NOTHING — the steady-state
    zero-writes discipline holds with the ledger attached."""
    from slurm_bridge_tpu_torch.bridge.objects import PolicyState
    from slurm_bridge_tpu_torch.bridge.store import ObjectStore

    store = ObjectStore()
    engine = PlacementPolicy(PolicyConfig())
    engine.save_to_store(store)  # never charged: no object appears
    assert store.try_get(PolicyState.KIND, PolicyState.FAIRSHARE_NAME) is None
    engine._tick_jobs = [("tenant-a", 0.5, 1)]
    engine.note_admitted([0])
    engine.save_to_store(store)
    obj = store.try_get(PolicyState.KIND, PolicyState.FAIRSHARE_NAME)
    assert obj is not None and obj.usage == {"tenant-a": 0.5}
    rv = obj.meta.resource_version
    engine.save_to_store(store)  # clean again: no second write
    assert (
        store.get(PolicyState.KIND, PolicyState.FAIRSHARE_NAME)
        .meta.resource_version
        == rv
    )


# ------------------------------------------------ preemption cancel retry


def test_failed_preempt_cancel_is_retried():
    """A cancel that fails while the agent is unreachable must not be
    dropped after one attempt (it would orphan the Slurm job while the
    requeued pod resubmits — double execution). It is annotated on the
    pod and retried at the top of every tick until it lands."""
    from slurm_bridge_tpu_torch.bridge.objects import Meta, Pod, PodPhase, PodSpec, PodStatus
    from slurm_bridge_tpu_torch.bridge.scheduler import (
        PENDING_CANCEL_ANNOTATION,
        PlacementScheduler,
    )
    from slurm_bridge_tpu_torch.bridge.store import ObjectStore
    from slurm_bridge_tpu_torch.wire import RpcError, StatusCode

    class _Client:
        def __init__(self):
            self.down = True
            self.cancelled = []

        def CancelJob(self, req, timeout=None):
            if self.down:
                raise RpcError(StatusCode.UNAVAILABLE, "agent unreachable")
            self.cancelled.append(req.job_id)

    store = ObjectStore()
    client = _Client()
    sched = PlacementScheduler(store, client, backend="greedy")
    store.create(
        Pod(
            meta=Meta(name="victim"),
            spec=PodSpec(
                partition="tiny",
                node_name="slurm-partition-tiny",
                placement_hint=("t1",),
            ),
            status=PodStatus(phase=PodPhase.RUNNING, job_ids=(7, 8)),
        )
    )
    assert sched._preempt(store.get(Pod.KIND, "victim"))
    pod = store.get(Pod.KIND, "victim")
    assert pod.meta.annotations[PENDING_CANCEL_ANNOTATION] == "7,8"
    assert not pod.status.job_ids  # requeued regardless

    sched._retry_pending_cancels()  # agent still down: backlog intact
    pod = store.get(Pod.KIND, "victim")
    assert pod.meta.annotations[PENDING_CANCEL_ANNOTATION] == "7,8"

    client.down = False
    sched._retry_pending_cancels()  # agent back: backlog drains
    assert client.cancelled == [7, 8]
    pod = store.get(Pod.KIND, "victim")
    assert PENDING_CANCEL_ANNOTATION not in pod.meta.annotations
