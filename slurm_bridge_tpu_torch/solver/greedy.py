"""Reference greedy packer — the correctness oracle and parity baseline.

Priority-ordered first-fit/best-fit, one shard at a time, gang groups
admitted all-or-nothing. This reproduces (in spirit) what the reference's
stack achieves with kube-scheduler defaults plus partition affinity
(SURVEY.md §6 "Scheduling algorithm") as an in-process packer, and is the
baseline the device auction is measured against (BASELINE.md).

This implementation is intentionally simple and sequential; the C++
sibling (:mod:`greedy_native`) is the performance-tuned version of the
same algorithm.
"""

from __future__ import annotations

import numpy as np

from slurm_bridge_tpu_torch.solver.snapshot import ClusterSnapshot, JobBatch, Placement


def greedy_place(
    snapshot: ClusterSnapshot,
    batch: JobBatch,
    *,
    best_fit: bool = True,
    incumbent: np.ndarray | None = None,
    policy: str | None = None,
) -> Placement:
    """Place shards in priority order; gangs are all-or-nothing.

    For each gang (in max-priority order), tentatively place every shard
    via the fit ``policy``; commit only if all shards fit:

    - ``"best"`` (default; ``best_fit=True``): least leftover cpu, lowest
      node index on ties — the reference-parity algorithm;
    - ``"first"`` (``best_fit=False``): lowest node index that fits;
    - ``"worst"``: MOST free cpu, highest node index on ties — the
      measured quality winner at the 50k×10k headline (45,236 jobs vs
      best-fit's 44,928 and first-fit's 45,183, BASELINE.md round 5):
      spreading load preserves multi-dim balance where min-cpu packing
      strands memory.

    ``incumbent`` ([P] int32, -1 = free agent) pins a shard to the node it
    already runs on (streaming semantics — a running Slurm job cannot
    migrate, SURVEY.md §6). Pinned shards are handled reserve-first,
    preempt-only-when-necessary — the Slurm preemption model, NOT the
    auction kernel's contention preemption:

    1. **Reservation pass** (priority order): each pinned shard re-validates
       its node (partition/feature — a node can be relabeled while a shard
       runs on it — and capacity) and reserves its demand there. A shard
       whose node no longer accommodates it stays unreserved.
    2. **Admission** (the usual priority-ordered gang loop): a reserved
       shard converts its reservation into a placement. An unreserved
       pinned shard re-checks its node against what is left. A free agent
       best-fits against unreserved capacity; only when NOTHING fits may it
       evict reserved incumbents — strictly lower-priority, not yet
       committed, not its own gang-mates, lowest priority first — on the
       node with the least potential capacity that suffices. Gangs stay
       all-or-nothing: a failed gang rolls back its placements and
       evictions and releases its own members' reservations (those
       incumbents are preempted).

    ``snapshot.free`` must have all modeled usage released
    (external/unmodeled allocations already subtracted — :mod:`streaming`).
    This function is the semantic oracle; the C++ twin
    (``native/indexed.cpp``) must place bit-identically.
    """
    if policy is None:
        policy = "best" if best_fit else "first"
    if policy not in ("best", "first", "worst"):
        raise ValueError(f"unknown fit policy {policy!r}")
    free = snapshot.free.copy()
    part_of = snapshot.partition_of
    feats = snapshot.features
    p = batch.num_shards
    node_of = np.full(p, -1, dtype=np.int32)
    pins = (
        np.full(p, -1, np.int32)
        if incumbent is None
        else np.asarray(incumbent, np.int32)
    )
    if (pins >= snapshot.num_nodes).any():
        # same contract as the native packer's rc=-1, so callers see one
        # error type whichever engine (or fallback) serves the solve
        raise ValueError("incumbent pin out of range")

    # group shards by gang, order gangs by priority (desc), stable
    order = np.argsort(-batch.priority, kind="stable")
    gangs: dict[int, list[int]] = {}
    gang_order: list[int] = []
    for idx in order:
        g = int(batch.gang_id[idx])
        if g not in gangs:
            gangs[g] = []
            gang_order.append(g)
        gangs[g].append(int(idx))

    def _fits(nd: int, s: int) -> bool:
        jp = batch.partition_of[s]
        rf = np.uint32(batch.req_features[s])
        return bool(
            (jp < 0 or part_of[nd] == jp) and (feats[nd] & rf) == rf
        )

    # ---- reservation pass (admission order): pinned shards re-validate
    # and reserve their node's capacity up front, so free agents best-fit
    # around running work instead of through it
    reserved = np.zeros(p, bool)  # True = reservation alive (uncommitted)
    rank = np.empty(p, np.int64)  # admission rank; evict last-admitted first
    rank[order] = np.arange(p)
    n_reserved = 0
    for s in order:
        pin = int(pins[s])
        if pin < 0:
            continue
        if _fits(pin, s) and np.all(free[pin] >= batch.demand[s]):
            free[pin] -= batch.demand[s]
            reserved[s] = True
            n_reserved += 1

    def _tier2(trial, s, g, gang_nodes):
        """Preempt-only-when-necessary: the node with the least potential
        capacity (own free + lower-priority uncommitted reservations) that
        fits shard ``s``, plus the eviction list (rank desc) that makes
        room. None when no legal eviction set exists anywhere."""
        prio_s = batch.priority[s]
        dem = batch.demand[s]
        best_nd = -1
        best_cpu = np.inf
        best_evict: list[int] = []
        for nd in range(snapshot.num_nodes):
            if nd in gang_nodes or not _fits(nd, s):
                continue
            evictable = [
                int(e)
                for e in np.nonzero(
                    reserved & (pins == nd) & (node_of < 0)
                    & (batch.priority < prio_s) & (batch.gang_id != g)
                )[0]
            ]
            if not evictable:
                continue
            # rank-asc sequential accumulation — float-add order must match
            # the C++ twin's per-node reservation list exactly
            evictable.sort(key=lambda e: rank[e])
            pot = trial[nd].copy()
            for e in evictable:
                pot += batch.demand[e]
            if not np.all(pot >= dem):
                continue
            if pot[0] < best_cpu:  # first strict min wins ⇒ lowest index
                best_nd, best_cpu = nd, pot[0]
                best_evict = evictable[::-1]  # evict last-admitted first
        if best_nd < 0:
            return None
        do_evict = []
        for e in best_evict:
            if np.all(trial[best_nd] >= dem):
                break
            trial[best_nd] += batch.demand[e]
            do_evict.append(e)
        return best_nd, do_evict

    for g in gang_order:
        shards = gangs[g]
        trial = free  # copy lazily only for multi-shard gangs
        if len(shards) > 1:
            trial = free.copy()
        chosen: list[tuple[int, int, bool]] = []  # (shard, node, was_reserved)
        evicted_this: list[int] = []
        gang_nodes: set[int] = set()  # multi-node gangs need distinct nodes
        ok = True
        for s in shards:
            dem = batch.demand[s]
            pin = int(pins[s])
            was_reserved = False
            if pin >= 0 and reserved[s]:
                # reservation converts into the placement — nothing to
                # subtract, but gang distinctness still applies
                if pin in gang_nodes:
                    ok = False
                    break
                pick = pin
                was_reserved = True
            elif pin >= 0:
                # lost (or never got) its reservation: one last chance on
                # whatever its node has left — pinned shards never evict
                if not (
                    _fits(pin, s)
                    and np.all(trial[pin] >= dem)
                    and pin not in gang_nodes
                ):
                    ok = False
                    break
                pick = pin
            else:
                jp = batch.partition_of[s]
                rf = np.uint32(batch.req_features[s])
                mask = np.all(trial >= dem, axis=1)
                if jp >= 0:
                    mask &= part_of == jp
                if rf:
                    mask &= (feats & rf) == rf
                if gang_nodes:
                    mask[list(gang_nodes)] = False
                cand = np.nonzero(mask)[0]
                if cand.size:
                    if policy == "best":
                        leftover = trial[cand, 0] - dem[0]
                        pick = int(cand[np.argmin(leftover)])
                    elif policy == "worst":
                        m = trial[cand, 0]
                        pick = int(cand[np.nonzero(m == m.max())[0][-1]])
                    else:
                        pick = int(cand[0])
                elif n_reserved and policy == "best":
                    hit = _tier2(trial, s, g, gang_nodes)
                    if hit is None:
                        ok = False
                        break
                    pick, evs = hit
                    for e in evs:
                        reserved[e] = False
                        n_reserved -= 1
                    evicted_this.extend(evs)
                else:
                    ok = False
                    break
            if not was_reserved:
                trial[pick] -= dem
            chosen.append((s, pick, was_reserved))
            if len(shards) > 1:
                gang_nodes.add(pick)
        if ok:
            if trial is not free:
                free = trial
            for s, pick, _ in chosen:
                node_of[s] = pick
        else:
            # gang dropped: trial copy discarded; un-evict (their capacity
            # lives only in the discarded trial), then release THIS gang's
            # own reservations — its incumbents are preempted as a unit
            for e in evicted_this:
                reserved[e] = True
                n_reserved += 1
            for s in shards:
                if reserved[s]:
                    free[int(pins[s])] += batch.demand[s]
                    reserved[s] = False
                    n_reserved -= 1

    placed = node_of >= 0
    return Placement(node_of=node_of, placed=placed, free_after=free)
