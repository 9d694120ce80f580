"""Shard planning — partition/island decomposition of one placement tick.

The 10×-scale tick (500k pods × 100k nodes) cannot stay monolithic: one
encode, one solve and one bind over the whole cluster serializes work
that is naturally independent, because a Slurm job can only ever place
inside its own partition. The planner exploits exactly that boundary:

- every **island** is a partition-local group of interchangeable nodes —
  the partition's GPU nodes form one island, its CPU nodes another, and
  an island bigger than ``max_nodes_per_shard`` splits into contiguous
  chunks (the trace generator's GPU islands map 1:1 onto these);
- islands are packed into **shards** (first-fit-decreasing, stable
  order), so a shard is a self-contained sub-cluster: a small partition
  rides whole inside one shard, a huge partition spans several;
- **demand is routed** to shards along the same boundary: a job's
  partition names its candidate shards. Gangs are routed WHOLE — all
  shards of a gang go to the one shard holding its best island (the
  rank-aware locality score below) — so gang atomicity never crosses a
  shard boundary inside the fan-out; gangs the chosen shard still could
  not place get a cross-shard second chance in
  :mod:`slurm_bridge_tpu_torch.shard.reconcile`.

Rank-aware locality (arxiv 2603.22691's quality bar — tightly-coupled
MPI gangs keep topology locality when the cluster is split): demand is
routed in descending effective-priority order, so a production gang
claims its best island before best-effort work dilutes it, and the score
prefers (1) a shard that can host the whole gang, (2) a shard where one
single island can host it (ICI-local placement), (3) the least-loaded
shard — ties break on shard id, keeping the whole pass deterministic.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from slurm_bridge_tpu_torch.core.types import JobDemand, NodeInfo, PartitionInfo


@dataclass(frozen=True)
class ShardConfig:
    """Declarative sharding knobs — frozen + scalar-valued so a
    :class:`~slurm_bridge_tpu_torch.sim.harness.Scenario` can carry one."""

    #: islands bigger than this split into contiguous chunks, and a
    #: shard never grows past it — the per-shard solve stays small
    #: enough that encode+solve cost is O(cluster/shards)
    max_nodes_per_shard: int = 4096
    #: per-shard solve fan-out width (1 = serial). Encodes always run
    #: serially — the shared feature-code table must grow in a
    #: deterministic order — and merges are keyed by shard id, so the
    #: result is byte-identical at any width.
    workers: int = 1
    #: cross-shard gang reconciliation pass (shard/reconcile.py)
    reconcile: bool = True
    #: reconcile candidates examined per tick (rank-major order)
    reconcile_limit: int = 512
    #: multi-device shard_map solve for big shards: None = the routing
    #: auto rule (≥2 devices AND P×N ≥ sharded_threshold), False = never
    #: (CPU-only fallback), True = force-try whenever ≥2 devices exist
    device_solve: bool | None = None
    #: P×N floor for the device shard_map sweep (routing.use_sharded)
    sharded_threshold: int = 1 << 20
    #: drift re-key threshold (ISSUE 17): when > 0 and any shard's
    #: drained-node fraction exceeds it, the plan re-keys with drained
    #: nodes quarantined into their own islands instead of keeping stale
    #: boundaries (a half-drained shard solves at half capacity but
    #: still pays full encode). 0 disables the probe — every pinned
    #: digest is preserved because the plan key never changes shape.
    drift_rekey_fraction: float = 0.0


@dataclass(frozen=True)
class Island:
    """One partition-local group of interchangeable nodes."""

    key: tuple  # (partition, "gpu"|"cpu", chunk index)
    nodes: tuple[int, ...]  # positions into the tick's global node list


@dataclass
class Shard:
    sid: int
    node_idx: np.ndarray  # global node positions (island-contiguous)
    partitions: tuple[str, ...]
    island_keys: tuple[tuple, ...]


@dataclass
class ShardPlan:
    """The tick's shard layout + routing indexes (all deterministic)."""

    shards: list[Shard]
    islands: list[Island]
    #: partition name → shard ids holding its nodes (ascending)
    part_shards: dict[str, tuple[int, ...]]
    #: node name → global position
    name_pos: dict[str, int]
    #: global position → node name (immutable for the plan's lifetime —
    #: built once; an O(N) inversion per tick was real cost at 100k)
    pos_name: tuple[str, ...]
    #: global node position → owning shard id
    node_shard: np.ndarray
    #: global node position → global island index (-1 = unowned)
    node_island: np.ndarray
    #: (shard id, partition) → member global positions
    members: dict[tuple[int, str], np.ndarray]
    #: partition name → ALL member global positions (reconcile scans)
    part_nodes: dict[str, np.ndarray]
    #: layout key the executor caches the plan on
    token: tuple

    @property
    def num_shards(self) -> int:
        return len(self.shards)


def plan_token(
    partitions: list[PartitionInfo],
    nodes: list[NodeInfo],
    config: ShardConfig,
) -> tuple:
    """Identity of everything a cached plan indexes. The NODE list is
    part of the key, not just the partition layout: a node can vanish
    from the Nodes response while the partition still lists it, and a
    stale plan's positional indexes over the shorter list would shift
    every node after the gap (the monolithic encoder re-derives from
    the passed list every tick; the plan cache must re-key instead)."""
    return (
        tuple((p.name, p.nodes) for p in partitions),
        tuple(nd.name for nd in nodes),
        config.max_nodes_per_shard,
    )


def drained_positions(nodes: list[NodeInfo]) -> frozenset[int]:
    """Global positions of drained/down nodes (sim agent's drain rule)."""
    return frozenset(
        i
        for i, nd in enumerate(nodes)
        if "DRAIN" in nd.state.upper() or "DOWN" in nd.state.upper()
    )


def build_plan(
    partitions: list[PartitionInfo],
    nodes: list[NodeInfo],
    config: ShardConfig,
    drained: frozenset[int] = frozenset(),
) -> ShardPlan:
    """Decompose the inventory into islands and pack them into shards.

    ``drained`` (global node positions) quarantines those nodes into
    dedicated ``<kind>-drained`` islands — the drift re-key path: live
    nodes re-pack densely while the drained remainder stays routable (a
    node can un-drain next tick) without diluting live shards.
    """
    cap = max(1, config.max_nodes_per_shard)
    name_pos = {nd.name: i for i, nd in enumerate(nodes)}
    owned: set[int] = set()
    islands: list[Island] = []
    for p in partitions:
        # first-claim ownership: a node listed by two partitions solves
        # in the first one's shard (cluster_state dedupes the same way)
        mine = [
            name_pos[n]
            for n in p.nodes
            if n in name_pos and name_pos[n] not in owned
        ]
        owned.update(mine)
        gpu = [i for i in mine if nodes[i].gpus > 0]
        cpu = [i for i in mine if nodes[i].gpus <= 0]
        groups: list[tuple[str, list[int]]] = []
        for kind, group in (("gpu", gpu), ("cpu", cpu)):
            if not drained:
                groups.append((kind, group))
                continue
            groups.append((kind, [i for i in group if i not in drained]))
            groups.append(
                (kind + "-drained", [i for i in group if i in drained])
            )
        for kind, group in groups:
            if not group:
                continue
            nchunks = (len(group) + cap - 1) // cap
            for c, chunk in enumerate(np.array_split(np.asarray(group), nchunks)):
                islands.append(
                    Island(key=(p.name, kind, c), nodes=tuple(chunk.tolist()))
                )

    # first-fit-decreasing island packing, stable on the island key
    order = sorted(
        range(len(islands)), key=lambda i: (-len(islands[i].nodes), islands[i].key)
    )
    bins: list[list[int]] = []  # island indices per shard
    room: list[int] = []
    for i in order:
        size = len(islands[i].nodes)
        placed = False
        for b, r in enumerate(room):
            if r >= size:
                bins[b].append(i)
                room[b] = r - size
                placed = True
                break
        if not placed:
            bins.append([i])
            room.append(cap - size)

    shards: list[Shard] = []
    node_shard = np.full(len(nodes), -1, np.int32)
    node_island = np.full(len(nodes), -1, np.int32)
    members: dict[tuple[int, str], list[int]] = {}
    part_shards: dict[str, set[int]] = {}
    for sid, isl_ids in enumerate(bins):
        isl_ids = sorted(isl_ids, key=lambda i: islands[i].key)
        idx: list[int] = []
        parts: set[str] = set()
        for i in isl_ids:
            isl = islands[i]
            idx.extend(isl.nodes)
            parts.add(isl.key[0])
            members.setdefault((sid, isl.key[0]), []).extend(isl.nodes)
            part_shards.setdefault(isl.key[0], set()).add(sid)
            for pos in isl.nodes:
                node_island[pos] = i
        node_arr = np.asarray(idx, np.int64)
        node_shard[node_arr] = sid
        shards.append(
            Shard(
                sid=sid,
                node_idx=node_arr,
                partitions=tuple(sorted(parts)),
                island_keys=tuple(islands[i].key for i in isl_ids),
            )
        )
    part_nodes = {
        p: np.concatenate(
            [np.asarray(members[(s, p)], np.int64) for s in sorted(sids)]
        )
        for p, sids in part_shards.items()
    }
    return ShardPlan(
        shards=shards,
        islands=islands,
        part_shards={p: tuple(sorted(s)) for p, s in part_shards.items()},
        name_pos=name_pos,
        pos_name=tuple(nd.name for nd in nodes),
        node_shard=node_shard,
        node_island=node_island,
        members={k: np.asarray(v, np.int64) for k, v in members.items()},
        part_nodes=part_nodes,
        token=(),
    )


def sub_partitions(
    plan: ShardPlan, partitions: list[PartitionInfo], sid: int
) -> list[PartitionInfo]:
    """Per-shard PartitionInfo list: each partition restricted to the
    nodes this shard owns (structural share of every other field)."""
    by_name = {p.name: p for p in partitions}
    out = []
    for pname in plan.shards[sid].partitions:
        p = by_name[pname]
        mine = plan.members[(sid, pname)]
        out.append(
            dataclasses.replace(
                p, nodes=tuple(plan.pos_name[int(i)] for i in mine)
            )
        )
    return out


def route_demand_vec(d: JobDemand | None) -> tuple[np.ndarray, int]:
    """(per-shard [cpu, mem, gpu] ask, shard count) for routing — the
    same totals-divided-across-shards rule the encoder lowers with."""
    if d is None:
        return np.asarray([1.0, 0.0, 0.0], np.float32), 1
    from slurm_bridge_tpu_torch.core.arrays import array_len

    arr = array_len(d.array) if d.array else 1
    nsh = max(1, d.nodes)
    cpus = float(d.total_cpus(arr)) / nsh
    mem = float(d.total_mem_mb(arr)) / nsh
    gpu = 0.0
    if d.gres:
        parts = d.gres.split(":")
        try:
            gpu = float(int(parts[-1].split("(")[0]))
        except ValueError:
            gpu = 0.0
    return np.asarray([cpus, mem, gpu], np.float32), nsh


def route_jobs(
    plan: ShardPlan,
    free: np.ndarray,
    demands: list[JobDemand],
    all_pods: list,
    n_pending: int,
    priorities: list[float] | None = None,
) -> dict[int, list[int]]:
    """Assign every job index to one shard; returns shard id → global
    job indices (each list: pending ascending, then incumbents
    ascending — the per-shard ``all_pods`` order the executor encodes).

    Incumbents go to the shard owning their first hinted node (their
    allocation is already there). Pending jobs route in descending
    effective-priority order so high-rank gangs claim their best island
    first; the locality score is documented in the module docstring.
    """
    num_shards = plan.num_shards
    all_sids = tuple(range(num_shards))
    est_load = np.zeros(num_shards, np.float64)
    cap = np.asarray(
        [max(1.0, float(free[s.node_idx, 0].sum())) for s in plan.shards],
        np.float64,
    )
    out: dict[int, list[int]] = {}

    def assign(j: int, sid: int, load: float) -> None:
        out.setdefault(sid, []).append(j)
        est_load[sid] += load

    # incumbents first: pinned by their existing allocation
    for j in range(n_pending, len(all_pods)):
        pod = all_pods[j]
        hints = getattr(pod, "hint", None) or getattr(
            getattr(pod, "spec", None), "placement_hint", ()
        )
        sid = -1
        for h in hints:
            pos = plan.name_pos.get(h)
            if pos is not None and plan.node_shard[pos] >= 0:
                sid = int(plan.node_shard[pos])
                break
        if sid < 0:
            cands = plan.part_shards.get(demands[j].partition, all_sids)
            sid = cands[0]
        d, nsh = route_demand_vec(demands[j])
        assign(j, sid, float(d[0]) * nsh)

    if priorities is not None:
        prio = [float(priorities[j]) for j in range(n_pending)]
    else:
        prio = [
            float(demands[j].priority if demands[j] else 0.0)
            for j in range(n_pending)
        ]
    # feasibility memo: jobs draw from a handful of demand shapes, so
    # (shard, partition, demand) → (feasible count, best-island count)
    # turns 500k per-job vector scans into a few thousand — routing
    # stays O(jobs + shapes × shards), not O(jobs × nodes)
    feas_memo: dict[tuple, tuple[int, int]] = {}

    def feas_of(sid: int, part: str, d: np.ndarray) -> tuple[int, int]:
        key = (sid, part, d.tobytes())
        hit = feas_memo.get(key)
        if hit is None:
            m = plan.members.get((sid, part))
            if m is None:
                # "any partition" job: score the whole shard
                m = plan.shards[sid].node_idx
            ok = (free[m] >= d).all(axis=1)
            feas = int(ok.sum())
            isl_best = 0
            if feas:
                isl = plan.node_island[m[ok]]
                isl = isl[isl >= 0]
                isl_best = int(np.bincount(isl).max()) if isl.size else 0
            hit = feas_memo[key] = (feas, isl_best)
        return hit

    for j in sorted(range(n_pending), key=lambda j: (-prio[j], j)):
        part = demands[j].partition
        cands = plan.part_shards.get(part) if part else None
        if cands is None:
            cands = all_sids
        d, need = route_demand_vec(demands[j])
        load = float(d[0]) * need
        if len(cands) == 1:
            assign(j, cands[0], load)
            continue
        best = None
        for sid in cands:
            feas, isl_best = feas_of(sid, part, d)
            score = (
                feas >= need,
                isl_best >= need,
                -est_load[sid] / cap[sid],
                -sid,
            )
            if best is None or score > best[0]:
                best = (score, sid)
        assign(j, best[1], load)

    # per-shard order: pending ascending then incumbents ascending — the
    # JobRowCache key lists stay stable across steady-state ticks
    for sid, js in out.items():
        out[sid] = sorted(
            js, key=lambda j: (0 if j < n_pending else 1, j)
        )
    return out
