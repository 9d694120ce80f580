"""The port's streaming admission against the JAX package's tests.

Twins of the ``tests/test_admission.py`` cases that need no simulator:
the fuzzed fast-path ≡ guarded-backfill oracle, the guard and rollback
directed cases, the residual view ≡ recomputed free_after oracle, the
eligibility table, and the end-to-end ``PlacementScheduler.admit`` cases
— the last against an in-process agent serving the same idle nodes the
simulator's would (no job is ever submitted in them). The off-fixture and
storm-scenario cases wait for the simulator's port.
"""

import numpy as np

from chip_smoke import InventoryClient
from slurm_bridge_tpu_torch.admission import AdmissionConfig, FastPathAdmitter
from slurm_bridge_tpu_torch.admission.residual import ResidualView
from slurm_bridge_tpu_torch.bridge.objects import (
    Meta,
    NodeCondition,
    Pod,
    PodRole,
    PodSpec,
    VirtualNode,
    partition_node_name,
)
from slurm_bridge_tpu_torch.bridge.scheduler import PlacementScheduler
from slurm_bridge_tpu_torch.bridge.store import ObjectStore
from slurm_bridge_tpu_torch.core.types import JobDemand, NodeInfo, PartitionInfo
from slurm_bridge_tpu_torch.policy.classes import CLASS_LABEL
from slurm_bridge_tpu_torch.policy.engine import feasible_nodes
from slurm_bridge_tpu_torch.solver.snapshot import ClusterSnapshot, job_scalars
from slurm_bridge_tpu_torch.wire import convert, pb


# ---------------------------------------------------- synthetic windows


def _snapshot(rng: np.random.Generator, n_nodes: int, n_parts: int):
    """A random window snapshot: mixed partitions, a couple of feature
    bits, free capacity drawn wide enough to exercise both fits and
    misses."""
    free = np.stack(
        [
            rng.integers(0, 9, n_nodes).astype(np.float32),
            rng.integers(0, 32_000, n_nodes).astype(np.float32),
            np.zeros(n_nodes, np.float32),
        ],
        axis=1,
    )
    features = rng.integers(0, 4, n_nodes).astype(np.uint32)
    return ClusterSnapshot(
        node_names=[f"n{i:03d}" for i in range(n_nodes)],
        capacity=free.copy(),
        free=free.copy(),
        partition_of=rng.integers(0, n_parts, n_nodes).astype(np.int32),
        features=features,
        partition_codes={f"part{k}": k for k in range(n_parts)},
        feature_codes={"f0": 0, "f1": 1},
    ), free


def _demand(rng: np.random.Generator, n_parts: int) -> JobDemand:
    return JobDemand(
        partition=f"part{int(rng.integers(0, n_parts))}",
        cpus_per_task=int(rng.integers(1, 5)),
        ntasks=int(rng.integers(1, 3)),
        nodes=int(rng.integers(1, 5)),
        mem_per_cpu_mb=int(rng.choice([0, 1024, 2048])),
    )


# ------------------------- fuzzed fast-path ≡ guarded-backfill oracle


def test_fuzzed_fastpath_binds_satisfy_the_backfill_guard():
    """Every fast-path accept, rechecked from scratch: feasible fit on
    the PRE-admit residual for every chosen node, and every protected
    equal-or-higher-class gang still feasible afterwards — exactly the
    guard-checked backfill's acceptance predicate. Every miss leaves
    the residual byte-identical."""
    rng = np.random.default_rng(1207)
    accepts = rejects = 0
    for _case in range(60):
        n_parts = int(rng.integers(1, 4))
        snapshot, free0 = _snapshot(rng, int(rng.integers(6, 24)), n_parts)
        adm = FastPathAdmitter(AdmissionConfig())
        backlog = [
            (_demand(rng, n_parts), int(rng.integers(0, 4)))
            for _ in range(int(rng.integers(0, 5)))
        ]
        adm.begin_window(snapshot, free0, backlog)
        # the protected set the ORACLE recomputes from the raw backlog
        protected = []
        for d, rank in backlog:
            cpu, mem, gpu, part, req, need, _ = job_scalars(d, snapshot)
            if need <= 1 or part < 0:
                continue
            dv = np.asarray([cpu, mem, gpu], np.float32)
            if int(
                feasible_nodes(
                    adm.view.free, snapshot.partition_of,
                    snapshot.features, dv, part, req,
                ).sum()
            ) >= need:
                protected.append((dv, part, req, need, rank))
        for _attempt in range(8):
            cand = _demand(rng, n_parts)
            rank = int(rng.integers(0, 4))
            if cand.nodes > 4:
                continue  # admit() is only ever called on eligibles
            pre = adm.view.free.copy()
            names, reason, token = adm.admit(cand, rank)
            cpu, mem, gpu, part, req, need, _ = job_scalars(cand, snapshot)
            dv = np.ceil(np.asarray([cpu, mem, gpu], np.float32))
            if not names:
                rejects += 1
                assert np.array_equal(adm.view.free, pre), (
                    "a miss mutated the residual"
                )
                continue
            accepts += 1
            chosen, _d, _hits = token
            assert len(names) == need == len(set(names))
            for n in chosen:
                # the fit half of the guard, on the PRE-admit residual
                assert snapshot.partition_of[n] == part
                assert (np.uint32(req) & ~snapshot.features[n]) == 0
                assert (pre[n] >= dv).all()
            # the no-delay half: every protected gang of equal-or-
            # higher class that was STILL feasible before this bind
            # (gangs a higher-class bind already displaced are dead —
            # backfill's "already infeasible cannot be delayed") stays
            # feasible after it, recomputed from scratch
            for gdv, gpart, greq, gneed, grank in protected:
                if grank < rank:
                    continue
                pre_count = int(
                    feasible_nodes(
                        pre, snapshot.partition_of,
                        snapshot.features, gdv, gpart, greq,
                    ).sum()
                )
                if pre_count < gneed:
                    continue
                count = int(
                    feasible_nodes(
                        adm.view.free, snapshot.partition_of,
                        snapshot.features, gdv, gpart, greq,
                    ).sum()
                )
                assert count >= gneed, (
                    "fast-path bind starved a protected gang"
                )
            # the residual moved by exactly the ceil'd demand
            recomputed = pre.copy()
            for n in chosen:
                recomputed[n] -= dv
            assert np.array_equal(adm.view.free, recomputed)
    assert accepts > 20 and rejects > 20, (
        f"fuzz degenerated: {accepts} accepts / {rejects} rejects"
    )


def test_guard_rejects_a_take_that_starves_a_protected_gang():
    """Directed: two nodes exactly fit a protected 2-node gang; a
    single that would break either node's fit must be refused even
    though it FITS — and admitted the moment headroom appears."""
    free = np.asarray(
        [[2.0, 8192.0, 0.0], [2.0, 8192.0, 0.0]], np.float32
    )
    snapshot = ClusterSnapshot(
        node_names=["a", "b"],
        capacity=free.copy(),
        free=free.copy(),
        partition_of=np.zeros(2, np.int32),
        features=np.zeros(2, np.uint32),
        partition_codes={"part0": 0},
        feature_codes={},
    )
    gang = JobDemand(partition="part0", cpus_per_task=2, ntasks=2, nodes=2)
    single = JobDemand(partition="part0", cpus_per_task=1)
    adm = FastPathAdmitter(AdmissionConfig())
    adm.begin_window(snapshot, free, [(gang, 3)])
    names, reason, _tok = adm.admit(single, rank=2)  # lower class
    assert not names and reason == "guard"
    # headroom appears: same take now leaves the gang feasible
    roomy = free + np.asarray([1.0, 0.0, 0.0], np.float32)
    adm.begin_window(snapshot, roomy, [(gang, 3)])
    names, reason, _tok = adm.admit(single, rank=2)
    assert names and len(names) == 1
    # a HIGHER-class single is not guarded by a lower-class gang
    adm.begin_window(snapshot, free.copy(), [(gang, 1)])
    names, reason, _tok = adm.admit(single, rank=2)
    assert names


def test_rollback_restores_guard_bookkeeping_not_just_free():
    """A store-bind conflict rolls back the WHOLE reservation: the
    residual free AND the protected-gang masks/counts the takes
    decremented — otherwise the guard counts a still-feasible gang as
    partially starved for the rest of the window (and, dead-gang rule
    in hand, stops protecting it entirely)."""
    free0 = np.asarray(
        [[3.0, 8192.0, 0.0]] * 3, np.float32
    )
    snapshot = ClusterSnapshot(
        node_names=["a", "b", "c"],
        capacity=free0.copy(),
        free=free0.copy(),
        partition_of=np.zeros(3, np.int32),
        features=np.zeros(3, np.uint32),
        partition_codes={"part0": 0},
        feature_codes={},
    )
    # gang: need 2 shards of [2, 2048, 0] — all 3 nodes feasible
    gang = JobDemand(partition="part0", cpus_per_task=2, ntasks=2, nodes=2)
    # single whose take drops a node below the gang's per-shard demand
    fat = JobDemand(partition="part0", cpus_per_task=2)
    adm = FastPathAdmitter(AdmissionConfig())
    adm.begin_window(snapshot, free0, [(gang, 3)])
    g = adm.protected[0]
    assert g["count"] == 3
    names, reason, token = adm.admit(fat, rank=3)
    assert names  # 3-1=2 ≥ need: the guard allows this take
    assert g["count"] == 2  # ...and recorded the feasibility hit
    adm.rollback(token)
    # BOTH halves restored: free byte-identical to window start, and
    # the gang's mask/count fully live again
    assert np.array_equal(adm.view.free, free0)
    assert g["count"] == 3 and bool(g["mask"].all())
    # protection behaves exactly as in a fresh window: one more take
    # fits, the next would starve the gang and is refused
    names2, _r2, _t2 = adm.admit(fat, rank=3)
    assert names2
    names3, reason3, _t3 = adm.admit(fat, rank=3)
    assert not names3 and reason3 == "guard"


# --------------------- residual view ≡ recomputed free_after oracle


def test_residual_view_equals_recomputed_free_under_interleavings():
    rng = np.random.default_rng(77)
    snapshot, free0 = _snapshot(rng, 16, 2)
    view = ResidualView()
    view.begin_window(snapshot, free0)
    ledger: list[tuple[list[int], np.ndarray]] = []
    for _ in range(200):
        op = rng.random()
        if op < 0.55 or not ledger:
            positions = rng.choice(16, size=int(rng.integers(1, 4)),
                                   replace=False).tolist()
            d = np.asarray(
                [float(rng.integers(0, 3)), float(rng.integers(0, 2048)), 0.0],
                np.float32,
            )
            view.apply_bind(positions, d)
            ledger.append((positions, d))
        elif op < 0.85:
            k = int(rng.integers(0, len(ledger)))
            positions, d = ledger.pop(k)
            view.release(positions, d)
        else:
            # re-base (a fresh solve): the ledger resets with it
            free0 = np.abs(rng.normal(4, 2, (16, 3))).astype(np.float32)
            view.begin_window(snapshot, free0)
            ledger = []
        recomputed = free0.copy()
        for positions, d in ledger:
            for n in positions:
                recomputed[n] -= d
        assert np.allclose(view.free, recomputed, atol=1e-3)


# ------------------------------------------------ eligibility table


def test_eligibility_classes_and_gang_size():
    adm = FastPathAdmitter(AdmissionConfig())
    prod = {CLASS_LABEL: "production"}
    batch = {CLASS_LABEL: "batch"}
    single = JobDemand(partition="p")
    big = JobDemand(partition="p", nodes=8)
    small_gang = JobDemand(partition="p", nodes=4)
    assert adm.eligibility_rank(prod, single) is not None
    assert adm.eligibility_rank(prod, small_gang) is not None
    assert adm.eligibility_rank({CLASS_LABEL: "system"}, single) is not None
    assert adm.eligibility_rank(batch, single) is None  # class
    assert adm.eligibility_rank(prod, big) is None  # gang size
    assert adm.eligibility_rank({}, single) is None  # default class
    assert adm.eligibility_rank(prod, None) is None


# ------------------------------------------------------- end to end


def _interactive_pod(name: str, cpus: int = 1, nodes: int = 1) -> Pod:
    return Pod(
        meta=Meta(name=name, labels={CLASS_LABEL: "production"}),
        spec=PodSpec(
            role=PodRole.SIZECAR,
            partition="part0",
            demand=JobDemand(
                partition="part0",
                script="#!/bin/sh\ntrue\n",
                cpus_per_task=cpus,
                nodes=nodes,
                time_limit_s=1000,
                job_name=name,
            ),
        ),
    )


def _stack(n_nodes: int = 4, cpus: int = 8):
    nodes = [
        NodeInfo(name=f"n{i}", cpus=cpus, memory_mb=32_000)
        for i in range(n_nodes)
    ]
    client = InventoryClient(
        pb, convert, [PartitionInfo(name="part0", nodes=tuple(n.name for n in nodes))], nodes
    )
    store = ObjectStore()
    store.create(VirtualNode(
        meta=Meta(name=partition_node_name("part0")),
        partition="part0",
        conditions=[NodeCondition(type="Ready", status=True)],
    ))
    sched = PlacementScheduler(
        store, client, inventory_ttl=0.0, incremental=True,
        admission=AdmissionConfig(), device="cpu",
    )
    return store, sched


def test_admit_binds_an_eligible_arrival_between_ticks():
    store, sched = _stack()
    store.create(_interactive_pod("seed"))
    assert sched.tick() == 1  # the solve that opens the window
    store.create(_interactive_pod("fast", cpus=2))
    res = sched.admit("fast")
    assert res.eligible and res.bound
    pod = store.try_get(Pod.KIND, "fast")
    assert pod.spec.node_name == partition_node_name("part0")
    assert len(pod.spec.placement_hint) == 1
    # the in-flight deduction survives until the pod is visible
    # agent-side (job ids) — here nothing submitted it yet
    assert "fast" in sched.admission.deductions
    # a small production gang rides too, all-or-nothing
    store.create(_interactive_pod("gang", cpus=1, nodes=3))
    res = sched.admit("gang")
    assert res.bound and len(res.hint) == 3 and len(set(res.hint)) == 3


def test_admit_misses_fall_through_to_the_batch_tick():
    store, sched = _stack()
    store.create(_interactive_pod("seed"))
    sched.tick()
    # batch-class arrival: ineligible, untouched
    pod = _interactive_pod("bulk")
    pod.meta.labels = {CLASS_LABEL: "batch"}
    store.create(pod)
    res = sched.admit("bulk")
    assert not res.eligible and not res.bound
    assert store.try_get(Pod.KIND, "bulk").spec.node_name == ""
    # an infeasible interactive ask: eligible, missed, still pending
    store.create(_interactive_pod("huge", cpus=64))
    res = sched.admit("huge")
    assert res.eligible and not res.bound and res.reason == "no_fit"
    assert store.try_get(Pod.KIND, "huge").spec.node_name == ""
    # ... and the batch tick remains the repair path for it
    assert sched.admission.stats()["misses"]["no_fit"] == 1


def test_admit_before_any_window_misses_cleanly():
    store, sched = _stack()
    store.create(_interactive_pod("early"))
    res = sched.admit("early")
    assert res.eligible and not res.bound and res.reason == "no_window"
    # the batch tick then binds it
    assert sched.tick() == 1


def test_batch_tick_deducts_in_flight_fast_binds():
    """The double-claim guard: one node, capacity for one job; a fast
    bind claims it between ticks, so the next batch tick must NOT bind
    a second pod onto the same capacity even though the agent inventory
    still reports it free."""
    store, sched = _stack(n_nodes=1, cpus=4)
    store.create(_interactive_pod("seed", cpus=1))
    sched.tick()
    store.create(_interactive_pod("fast", cpus=3))
    assert sched.admit("fast").bound
    store.create(_interactive_pod("late", cpus=3))
    sched.tick()
    late = store.try_get(Pod.KIND, "late")
    assert late.spec.node_name == ""  # deduction kept it unplaced
    # the deduction makes the partition genuinely full — the explain
    # plane (ISSUE 15) attributes exactly that
    assert "Unschedulable: PARTITION_FULL" in late.status.reason
