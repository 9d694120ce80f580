"""What decides ``correct``: the bridge's decisions against the reference.

:class:`Recorder` sits on the harness under test during the run and keeps,
without copying, what the program decided at each tick: the Slurm node
readings the harness itself takes before the scheduler tick, each solve's
inventory, rows and placement, and each fast-path bind. After the window
:func:`judge` follows the whole run from tick 0 with the reference alone —
its own cluster and trace from the seed, its own pending set, inventory,
rows, fast-path window and placements — and counts every decision where
the program differs. Only the simulated Slurm's node readings are taken
from the run: they are the cluster's state, which both sides read.
"""

from __future__ import annotations

import time

import numpy as np

from bblib import reference as ref
from bblib.gen import CLASS_LABEL, Cluster, Job


#: the configuration's auction keys the reference implements (full argmax,
#: no affinity, no gang-first boost)
REFERENCE_AUCTION = {"rounds", "candidates", "repair", "dtype", "eta", "jitter",
                     "gang_salvage_rounds"}


class Recorder:
    """Hooks on one harness instance (its own attributes; the classes are
    untouched). ``tick`` is set by the loop before each tick."""

    def __init__(self, h):
        self.tick = -1
        self.truth: dict[int, dict] = {}
        self.solves: dict[int, dict] = {}
        self.fast: dict[int, dict[str, tuple[str, ...]]] = {}
        sched = h.scheduler
        free_now = h._free_now

        def free_now_hook():
            out = free_now()
            self.truth[self.tick] = out
            return out

        h._free_now = free_now_hook
        solve_local = sched._solve_local

        def solve_local_hook(partitions, nodes, demands, all_pods, n_pending, priorities=None):
            rec = {"pods": list(all_pods), "n_pending": n_pending}
            prev = sched.__dict__.get("_solve")
            solve = sched._solve

            def solve_hook(snapshot, batch, incumbent):
                placement = solve(snapshot, batch, incumbent)
                rec.update(snapshot=snapshot, batch=batch, incumbent=incumbent,
                           node_of=placement.node_of)
                return placement

            sched._solve = solve_hook
            try:
                return solve_local(partitions, nodes, demands, all_pods, n_pending, priorities)
            finally:
                if prev is None:
                    del sched._solve
                else:
                    sched._solve = prev
                self.solves[self.tick] = rec

        sched._solve_local = solve_local_hook
        if sched.admission is not None:
            admit = sched.admit

            def admit_hook(name):
                res = admit(name)
                if res.bound:
                    self.fast.setdefault(self.tick, {})[name] = tuple(res.hint)
                return res

            sched.admit = admit_hook


class Checks:
    """Named numbers, each beside its limit; ``max`` limits are upper
    bounds, ``min`` limits lower ones."""

    def __init__(self):
        self.items: dict[str, dict] = {}

    def add(self, name: str, value, limit, kind: str = "max") -> None:
        self.items[name] = {"value": value, "limit": limit, "kind": kind}

    def bump(self, name: str, by: int = 1) -> None:
        self.items[name]["value"] += by

    @property
    def ok(self) -> bool:
        return all(
            (c["value"] <= c["limit"]) if c["kind"] == "max" else (c["value"] >= c["limit"])
            for c in self.items.values()
        )

    def line(self) -> dict:
        return {k: {"value": c["value"], ("limit_max" if c["kind"] == "max" else "limit_min"):
                    c["limit"]} for k, c in self.items.items()}


def _cluster_diff(h, cl: Cluster) -> int:
    nodes = h.cluster.nodes
    bad = abs(len(nodes) - len(cl.names))
    for i, nm in enumerate(cl.names):
        nd = nodes.get(nm)
        if nd is None or (
            nd.cpus, nd.memory_mb, nd.gpus, nd.base_alloc_cpus, nd.base_alloc_memory_mb,
            nd.features,
        ) != (int(cl.cpus[i]), int(cl.mem[i]), int(cl.gpus[i]), int(cl.base_cpus[i]),
              int(cl.base_mem[i]), cl.features[i]):
            bad += 1
    if dict(h.cluster.partitions) != cl.partitions:
        bad += 1
    return bad


def _trace_diff(h, trace: list[list[Job]]) -> int:
    bad = abs(len(h.trace) - len(trace))
    for a, b in zip(h.trace, trace):
        bad += abs(len(a) - len(b))
        for x, y in zip(a, b):
            s = x.spec
            got = (x.name, s.partition, s.cpus_per_task, max(1, s.ntasks), s.nodes,
                   s.mem_per_cpu_mb, s.gres, s.priority, x.duration_s,
                   x.labels.get(CLASS_LABEL, ""))
            want = (y.name, y.partition, y.cpus_per_task, 1, y.nodes, y.mem_per_cpu_mb,
                    y.gres, y.priority, y.duration_s, y.job_class)
            bad += got != want
    return bad


def _snapshot_diff(snap, r: ref.Snapshot) -> int:
    if list(snap.node_names) != r.names:
        return max(len(r.names), 1)
    if dict(snap.partition_codes) != r.part_codes or dict(snap.feature_codes) != r.feat_codes:
        return max(len(r.names), 1)
    bad = (
        (np.asarray(snap.partition_of) != r.part)
        | (np.asarray(snap.features, np.uint32) != r.feat)
        | (np.asarray(snap.free, np.float32) != r.free).any(1)
        | (np.asarray(snap.capacity, np.float32) != r.cap).any(1)
    )
    return int(bad.sum())


def _batch_diff(batch, b: ref.Batch) -> int:
    p = len(b.part)
    if batch.num_shards != p:
        return max(p, batch.num_shards, 1)
    bad = (
        (np.asarray(batch.demand, np.float32) != b.dem).any(1)
        | (np.asarray(batch.partition_of) != b.part)
        | (np.asarray(batch.req_features, np.uint32) != b.req)
        | (np.asarray(batch.priority, np.float32) != b.prio)
        | (np.asarray(batch.job_of, np.int64) != b.gang)
    )
    return int(bad.sum())


def judge(h, rec: Recorder, cl: Cluster, trace: list[list[Job]], config: dict,
          last_tick: int, *, device) -> tuple[Checks, dict]:
    """Follow the run from tick 0 to ``last_tick`` with the reference and
    count where the program's decisions differ. Returns the checks and a
    summary (jobs judged and failed, seconds the reference took)."""
    t0 = time.perf_counter()
    b_cfg = config["bridge"]
    auction_cfg = b_cfg["auction"]
    unsupported = {k: v for k, v in auction_cfg.items() if k not in REFERENCE_AUCTION}
    if unsupported or auction_cfg.get("candidates", 0) != 0:
        raise ValueError(f"the reference auction has no {unsupported or 'sampled candidates'}")
    policy, admission = bool(b_cfg["policy"]), bool(b_cfg["admission"])
    ck = Checks()
    ck.add("cluster_mismatch", _cluster_diff(h, cl), 0)
    ck.add("trace_mismatch", _trace_diff(h, trace), 0)
    for name in ("snapshot_mismatch", "pending_mismatch", "batch_mismatch",
                 "placement_mismatch", "bind_mismatch", "mirror_mismatch"):
        ck.add(name, 0, 0)
    if admission:
        ck.add("fast_path_mismatch", 0, 0)
    ck.add("solves_checked", 0, 1, "min")
    failed: set[str] = set()
    by_pod = {f"{j.name}-sizecar": j for arrivals in trace for j in arrivals}
    layout = ref.layout(cl)
    pending: list[Job] = []
    hints: dict[str, tuple[str, ...]] = {}
    window: ref.FastPath | None = None
    last = None  # (pending names, free bytes, node_of, batch, snap) of the last solve
    for t in range(last_tick + 1):
        arrivals = trace[t] if t < len(trace) else []
        fast_ref: dict[str, tuple[str, ...]] = {}
        if admission:
            for job in arrivals:
                hint = window.admit(job) if window is not None else None
                if hint:
                    fast_ref[f"{job.name}-sizecar"] = hint
            got = rec.fast.get(t, {})
            bad = {p for p in set(got) | set(fast_ref) if got.get(p) != fast_ref.get(p)}
            ck.bump("fast_path_mismatch", len(bad))
            failed |= bad
            hints.update(fast_ref)
        pending += [j for j in arrivals if f"{j.name}-sizecar" not in fast_ref]
        if policy:
            order, eff = ref.policy_order(pending)
        else:
            order, eff = sorted(pending, key=lambda j: j.name), None
        solve = rec.solves.get(t)
        if not order:
            if solve is not None:
                ck.bump("pending_mismatch", len(solve["pods"]))
            continue
        snap = ref.with_free(layout, rec.truth[t])
        for pod, hint in fast_ref.items():
            _shards, d = ref.shard_demand(by_pod[pod])
            for nm in hint:
                snap.free[layout.pos[nm]] -= np.ceil(d.astype(np.float32))
        names = tuple(f"{j.name}-sizecar" for j in order)
        if solve is None:
            # the bridge reused its last assignment: right only when the
            # pending set and the inventory are what that solve saw
            if last is None or last[0] != names or last[1] != snap.free.tobytes():
                ck.bump("pending_mismatch", len(names))
                failed |= set(names)
                continue
            node_of, b = last[2], last[3]
        else:
            ck.bump("solves_checked")
            got_names = [p.name for p in solve["pods"]]
            if got_names[: solve["n_pending"]] != list(names) or len(got_names) != solve["n_pending"]:
                bad = set(got_names) ^ set(names)
                ck.bump("pending_mismatch", max(len(bad), 1))
                failed |= bad
            if (np.asarray(solve["incumbent"]) >= 0).any():
                ck.bump("pending_mismatch", 1)
            ck.bump("snapshot_mismatch", _snapshot_diff(solve["snapshot"], snap))
            b = ref.batch(order, snap, eff)
            ck.bump("batch_mismatch", _batch_diff(solve["batch"], b))
            node_of = ref.auction(
                snap, b, rounds=int(auction_cfg.get("rounds", 8)),
                eta=float(auction_cfg.get("eta", 0.5)), jit=float(auction_cfg.get("jitter", 1.0)),
                salvage_rounds=int(auction_cfg.get("gang_salvage_rounds", 2)),
                dtype=auction_cfg.get("dtype", "float32"), device=device,
            )
            if auction_cfg.get("repair", True):
                node_of = ref.repair(snap, b, node_of)
            got = np.asarray(solve["node_of"], np.int64)
            if got.shape != node_of.shape:
                ck.bump("placement_mismatch", max(len(node_of), 1))
                failed |= set(names)
            else:
                rows = np.nonzero(got != node_of)[0]
                ck.bump("placement_mismatch", int(rows.size))
                failed |= {names[int(b.gang[r])] for r in rows}
        last = (names, snap.free.tobytes(), node_of, b, snap)
        placed: dict[int, list[int]] = {}
        for r in np.nonzero(node_of >= 0)[0]:
            placed.setdefault(int(b.gang[r]), []).append(int(node_of[r]))
        # the first tick's mirror makes the virtual nodes: binds start at tick 1
        if t >= 1:
            for j, nodes in placed.items():
                hints[names[j]] = tuple(snap.names[n] for n in nodes)
            pending = [job for j, job in enumerate(order) if j not in placed]
        if admission:
            backlog = [(job, ref.CLASS_RANKS[ref.job_class(job)])
                       for j, job in enumerate(order) if j not in placed and job.nodes > 1]
            window = ref.FastPath(snap, ref.window_residual(snap, b, node_of), backlog)
    summary = _bind_and_mirror(h, ck, hints, failed)
    summary["jobs"] = sum(len(trace[t]) for t in range(min(last_tick + 1, len(trace))))
    summary["failed"] = len(failed)
    summary["reference_s"] = time.perf_counter() - t0
    return ck, summary


def _bind_and_mirror(h, ck: Checks, hints: dict[str, tuple[str, ...]], failed: set[str]) -> dict:
    """Each pod the reference bound carries its nodes as the placement
    hint and reached Slurm once with that node list; after one more
    mirror, every pod's phase is what its Slurm jobs' states say."""
    from slurm_bridge_tpu_torch.bridge.objects import Pod

    h._mirror()
    pods = {p.name: p for p in h.store.list(Pod.KIND) if p.name.endswith("-sizecar")}
    jobs = h.cluster.jobs
    per_pod: dict[str, int] = {}  # Slurm jobs per pod (a job is named after its CR)
    for job in jobs.values():
        per_pod[f"{job.name}-sizecar"] = per_pod.get(f"{job.name}-sizecar", 0) + 1
    for name, pod in pods.items():
        want = hints.get(name)
        got = tuple(pod.spec.placement_hint) if pod.spec.node_name else None
        ids = list(pod.status.job_ids)
        bad = got != want
        if want is not None:
            bad |= len(ids) != 1 or any(
                tuple(jobs[int(i)].nodelist) != want for i in ids if int(i) in jobs
            ) or any(int(i) not in jobs for i in ids)
        bad |= per_pod.get(name, 0) > 1
        if bad:
            ck.bump("bind_mismatch")
            failed.add(name)
        states = [jobs[int(i)].state.name for i in ids if int(i) in jobs]
        if pod.status.phase != ref.pod_phase(states):
            ck.bump("mirror_mismatch")
            failed.add(name)
    missing = set(hints) - set(pods)
    ck.bump("bind_mismatch", len(missing))
    failed |= missing
    return {"pods": len(pods)}
