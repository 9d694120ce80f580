"""The plain reference: what the bridge should decide, worked out again.

Plain NumPy and PyTorch only, importing nothing of the program. From the
cluster and trace that :mod:`bblib.gen` makes from the seed, and from the
simulated Slurm's node readings at each tick, it builds

- the inventory a tick solves against (node order, partition and feature
  codes, free capacity) and the pending jobs' rows (per-shard demand,
  partition, required features, priority, gang);
- the placement: the fixed-round auction of the bridge's design (hash
  jitter minus a congestion price, feasibility masks, distinct nodes per
  gang, per-node priority-ordered admission, the price step, gang revoke
  and salvage), dense over each row's partition, in the configuration's
  scoring precision, then the exact best-fit repair of whatever stayed
  unplaced;
- with the policy on: the class-banded effective priorities; with
  admission on: the fast path's residual window, its tight-fit guarded
  binds and the deductions the next solve subtracts;
- the pod phase a Slurm job state mirrors to.

Every float sum that the placement depends on runs in the order the
design fixes (segment sums in row order, row sums left to right, the
price's ``log1p`` in float64 rounded once), so on the same device the
float32 reference and a sound float32 bridge agree exactly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from bblib.gen import GPU_FEATURE, Cluster, Job

M32 = 0xFFFFFFFF
IMPOSSIBLE_BIT = 1 << 31
#: classes of the default table, lowest first (their dense ranks)
CLASS_RANKS = {"best-effort": 0, "batch": 1, "production": 2, "system": 3}
DEFAULT_CLASS = "batch"
INTERACTIVE_RANKS = {CLASS_RANKS["production"], CLASS_RANKS["system"]}
MAX_FAST_GANG = 4
FAST_NODE_TRIES = 8


# ---- inventory and rows ----------------------------------------------------


@dataclass
class Snapshot:
    names: list[str]
    part: np.ndarray  # [N] int32 partition code
    feat: np.ndarray  # [N] uint32 feature bits
    cap: np.ndarray  # [N, 3] float32
    free: np.ndarray  # [N, 3] float32
    part_codes: dict[str, int]
    feat_codes: dict[str, int]
    pos: dict[str, int]  # node name -> index


def layout(cl: Cluster) -> Snapshot:
    """The inventory's fixed part, free capacity zero: partitions in the
    agent's listing order, each one's members in order (a node listed
    twice keeps its first place); partition codes by listing position;
    feature bits by first sight in node order."""
    names: list[str] = []
    seen: set[str] = set()
    for members in cl.partitions.values():
        for nm in members:
            if nm not in seen:
                seen.add(nm)
                names.append(nm)
    part_codes = {p: i for i, p in enumerate(cl.partitions)}
    node_part = {}
    for p, members in cl.partitions.items():
        for nm in members:
            node_part.setdefault(nm, part_codes[p])
    idx = np.asarray([int(nm[4:]) for nm in names], np.int64)
    feat_codes: dict[str, int] = {}
    feats = np.zeros(len(names), np.uint32)
    for k, i in enumerate(idx.tolist()):
        if cl.gpus[i] > 0:
            code = feat_codes.setdefault(GPU_FEATURE, len(feat_codes))
            feats[k] = np.uint32(1 << code)
    return Snapshot(
        names=names,
        part=np.asarray([node_part[nm] for nm in names], np.int32),
        feat=feats,
        cap=np.stack([cl.cpus[idx], cl.mem[idx], cl.gpus[idx]], 1).astype(np.float32),
        free=np.zeros((len(names), 3), np.float32),
        part_codes=part_codes,
        feat_codes=feat_codes,
        pos={nm: k for k, nm in enumerate(names)},
    )


def with_free(lay: Snapshot, free_of: dict[str, tuple[float, float, float]]) -> Snapshot:
    """The tick's inventory: the layout with free capacity as Slurm
    reports it (0 on an unschedulable node)."""
    free = np.asarray([free_of[nm] for nm in lay.names], np.float32).reshape(len(lay.names), 3)
    return dataclasses.replace(lay, free=free)


@dataclass
class Batch:
    jobs: list[str]  # pod names, in row-group order
    dem: np.ndarray  # [P, 3] float32 per-shard demand
    part: np.ndarray  # [P] int32
    req: np.ndarray  # [P] uint32
    prio: np.ndarray  # [P] float32
    gang: np.ndarray  # [P] int64 (job index)


def shard_demand(job: Job) -> tuple[int, np.ndarray]:
    """(shards, one shard's (cpu, mem, gpu)): the job's cpus spread evenly
    over its nodes, memory per cpu, GPUs per node."""
    shards = max(1, job.nodes)
    cpu = float(max(1, job.cpus_per_task)) / shards
    mem_per_cpu = float(job.mem_per_cpu_mb or 1024)
    return shards, np.asarray([cpu, cpu * mem_per_cpu, float(job.gpus)], np.float64)


def req_bits(job: Job, snap: Snapshot) -> int:
    """The feature bits a job requires: its GPU type's, or the reserved
    impossible bit where no node carries that type."""
    if not job.gpus:
        return 0
    code = snap.feat_codes.get(GPU_FEATURE)
    return IMPOSSIBLE_BIT if code is None else 1 << code


def batch(jobs: list[Job], snap: Snapshot, priorities: list[float] | None = None) -> Batch:
    """One row per shard of each job, in the given job order."""
    dem, part, req, prio, gang = [], [], [], [], []
    for j, job in enumerate(jobs):
        shards, d = shard_demand(job)
        r = req_bits(job, snap)
        p = float(job.priority) if priorities is None else float(priorities[j])
        for _ in range(shards):
            dem.append(d)
            part.append(snap.part_codes.get(job.partition, -1))
            req.append(r)
            prio.append(p)
            gang.append(j)
    return Batch(
        jobs=[f"{job.name}-sizecar" for job in jobs],
        dem=np.asarray(dem, np.float64).astype(np.float32).reshape(-1, 3),
        part=np.asarray(part, np.int32),
        req=np.asarray(req, np.uint32),
        prio=np.asarray(prio, np.float64).astype(np.float32),
        gang=np.asarray(gang, np.int64),
    )


def job_class(job: Job) -> str:
    return job.job_class if job.job_class in CLASS_RANKS else DEFAULT_CLASS


def policy_order(jobs: list[Job]) -> tuple[list[Job], list[float]]:
    """The policy's admission order and effective priorities for pending
    jobs of one tenant and no preemption pool: classes highest first,
    within a class priority descending then name; effective priority
    ``rank · count + slot`` with slots counting down from ``count − 2``."""
    order = sorted(jobs, key=lambda j: (-CLASS_RANKS[job_class(j)], -j.priority, j.name))
    count = len(order) + 2
    eff = []
    for pos, job in enumerate(order):
        rank = CLASS_RANKS[job_class(job)]
        slot = count - 2 - min(pos, count - 3)
        eff.append(float(rank * count + max(slot, 0)))
    return order, eff


# ---- the auction -------------------------------------------------------------


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & M32


def jitter(rows: torch.Tensor, nodes: torch.Tensor, salt: int, dtype) -> torch.Tensor:
    """[len(rows), len(nodes)] hash jitter in [0, 1) of global row and node
    indices and the round: a murmur-style avalanche of three uint32
    streams (carried in int64), top 24 bits scaled by 2^-24."""
    h = _mul32(rows[:, None] & M32, 0x9E3779B1) ^ _mul32(nodes[None, :] & M32, 0x85EBCA77) ^ (
        (salt & M32) * 0xC2B2AE3D & M32
    )
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return ((h >> 8).to(torch.float32) * (1.0 / (1 << 24))).to(dtype)


def _stable_order(*keys: torch.Tensor) -> torch.Tensor:
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def _row_order_sum(values: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """Per-segment sums of ``values`` rows, each segment added in row order
    from zero: the k-th row of every segment is added in the k-th pass."""
    out = values.new_zeros((n, *values.shape[1:]))
    if seg.numel() == 0:
        return out
    order = torch.sort(seg, stable=True).indices
    s = seg[order]
    counts = torch.bincount(seg, minlength=n)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(seg.numel(), device=seg.device) - starts[s]
    for k in range(int(rank.max()) + 1):
        sel = rank == k
        out.index_add_(0, s[sel], values[order][sel])
    return out


def _used(dem: torch.Tensor, assign: torch.Tensor, n: int) -> torch.Tensor:
    keep = assign >= 0
    return _row_order_sum(dem[keep], assign[keep].long(), n)


def _revoke(assign: torch.Tensor, gang: torch.Tensor) -> torch.Tensor:
    p = assign.shape[0]
    size = torch.bincount(gang, minlength=p)
    placed = torch.bincount(gang[assign >= 0], minlength=p)
    return torch.where((placed == size)[gang], assign, -1)


def _score(free, price, dem, part, req, node_part, node_feat, live, rnd, dtype, jit):
    """Best feasible node and its bid for each live row: every node of the
    row's partition (every node for a row of any partition), lowest node
    index on ties. Returns (choice [P] with ``n`` for none, best [P])."""
    p, n = dem.shape[0], free.shape[0]
    device = dem.device
    choice = torch.full((p,), n, dtype=torch.int64, device=device)
    best = torch.full((p,), float("-inf"), dtype=torch.float32, device=device)
    price_d = price.to(dtype)
    live_rows = torch.nonzero(live).squeeze(1)
    if live_rows.numel() == 0:
        return choice, best
    for code in torch.unique(part[live_rows]).tolist():
        rows = live_rows[part[live_rows] == code]
        nodes = (torch.arange(n, device=device) if code < 0
                 else torch.nonzero(node_part == code).squeeze(1))
        if nodes.numel() == 0:
            continue
        step = max(1, (1 << 22) // nodes.numel())
        for a in range(0, rows.numel(), step):
            r = rows[a:a + step]
            rf = req[r, None]
            ok = (node_feat[None, nodes] & rf) == rf
            ok &= (dem[r, None, :] <= free[None, nodes, :] + 1e-6).all(-1)
            bid = jitter(r, nodes, rnd, dtype) * jit - price_d[None, nodes]
            bid = torch.where(ok, bid, float("-inf"))
            k = bid.argmax(dim=1)
            val = bid.gather(1, k[:, None])[:, 0].float()
            choice[r] = torch.where(torch.isfinite(val), nodes[k], n)
            best[r] = val
    return choice, best


def auction(snap: Snapshot, b: Batch, *, rounds: int = 8, eta: float = 0.5, jit: float = 1.0,
            salvage_rounds: int = 2, dtype: str = "float32", device="cpu") -> np.ndarray:
    """The fixed-round auction: each shard's node index or −1."""
    p, n = b.dem.shape[0], len(snap.names)
    if p == 0 or n == 0:
        return np.full(p, -1, np.int64)
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    t = lambda a, d: torch.as_tensor(np.ascontiguousarray(a), dtype=d, device=device)  # noqa: E731
    free0 = t(snap.free, torch.float32)
    node_part = t(snap.part, torch.int64)
    node_feat = t(snap.feat.astype(np.int64), torch.int64)
    dem = t(b.dem, torch.float32)
    part = t(b.part, torch.int64)
    req = t(b.req.astype(np.int64), torch.int64)
    prio = t(b.prio, torch.float32)
    gang = torch.as_tensor(np.unique(b.gang, return_inverse=True)[1], dtype=torch.int64,
                           device=device)
    mean_cap = snap.cap.mean(axis=0)
    scale = t((1.0 / np.maximum(mean_cap, 1.0)).astype(np.float32), torch.float32)
    dem_n = (dem * scale).to(dt)
    sizes = torch.bincount(gang, minlength=p)
    multi = sizes[gang] > 1
    has_gangs = bool(multi.any())
    salvage_start = rounds - min(salvage_rounds, max(0, rounds - 1))
    prio_order = _stable_order(-(prio + 0.0))
    assign = torch.full((p,), -1, dtype=torch.int64, device=device)
    price = torch.zeros(n, dtype=torch.float32, device=device)
    for rnd in range(rounds):
        if has_gangs and rnd >= salvage_start:
            assign = _revoke(assign, gang)
        free = free0 - _used(dem, assign, n)
        unplaced = assign < 0
        choice, best = _score(free, price, dem, part, req, node_part, node_feat, unplaced,
                              rnd, dt, jit)
        valid = unplaced & torch.isfinite(best)
        choice = torch.where(valid & (choice < n), choice, n)
        if has_gangs:
            # distinct nodes within a gang: among shards of one gang on one
            # node (or on a node a sibling holds), the first keeps it
            eff = torch.where(assign >= 0, assign, choice)
            order = _stable_order(gang, (eff << 1) | unplaced.long())
            g_s, e_s = gang[order], eff[order]
            same = (g_s[1:] == g_s[:-1]) & (e_s[1:] == e_s[:-1])
            dup_s = torch.cat([same.new_zeros(1), same]) & (e_s < n) & multi[order]
            dup = torch.empty_like(dup_s)
            dup[order] = dup_s
            valid = valid & ~dup
            choice = torch.where(valid, choice, n)
        # per-node admission in priority order: a shard is admitted while
        # the running demand of its node's bidders fits the node's free
        order = prio_order[_stable_order(choice[prio_order])]
        c_s = choice[order]
        d_s = torch.where(valid[order, None], dem[order], 0.0).double()
        first = torch.cat([c_s.new_ones(1, dtype=torch.bool), c_s[1:] != c_s[:-1]])
        csum = torch.cumsum(d_s, 0)
        seg_start = torch.cummax(torch.where(first, torch.arange(p, device=device), 0), 0).values
        within = (csum - csum[seg_start] + d_s[seg_start]).float()
        free_c = torch.where((c_s < n)[:, None], free[c_s.clamp(0, n - 1)], 0.0)
        ok_s = (within <= free_c + 1e-6).all(1) & (c_s < n)
        admitted = torch.empty_like(ok_s)
        admitted[order] = ok_s
        admitted &= valid
        assign = torch.where(admitted & unplaced, torch.where(choice < n, choice, -1), assign)
        # congestion price: nodes asked for beyond their free rise
        req_n = _row_order_sum(dem_n.float()[valid], choice[valid], n)
        fs = free * scale
        have = ((fs[:, 0] + fs[:, 1]) + fs[:, 2]).clamp_min(1e-6)
        over = ((req_n[:, 0] + req_n[:, 1]) + req_n[:, 2]) / have
        price = price + eta * torch.log1p((over - 1.0).clamp_min(0.0).double()).float()
    if has_gangs:
        assign = _revoke(assign, gang)
    return assign.cpu().numpy()


def repair(snap: Snapshot, b: Batch, node_of: np.ndarray) -> np.ndarray:
    """Re-admit every shard the auction left unplaced against what it left
    free: gangs in priority order (stable), each shard on the feasible
    node with the least cpu left over (lowest index on ties), distinct
    nodes within a gang, a gang all or nothing.

    A shard is looked for only among its partition's nodes that carry its
    features, and not at all where one of its demands exceeds what every
    such node has left (the most of each resource over them, kept until a
    placement lowers it): the same answer as a scan of every node."""
    node_of = node_of.copy()
    placed = node_of >= 0
    free = snap.free.copy()
    for r in np.nonzero(placed)[0]:
        free[node_of[r]] -= b.dem[r]
    rows = np.nonzero(~placed)[0]
    if rows.size == 0:
        return node_of
    order = rows[np.argsort(-b.prio[rows], kind="stable")]
    gangs: dict[int, list[int]] = {}
    for r in order.tolist():
        gangs.setdefault(int(b.gang[r]), []).append(r)
    members: dict[tuple[int, int], np.ndarray] = {}
    most: dict[tuple[int, int], np.ndarray] = {}
    for shards in gangs.values():
        trial = free.copy() if len(shards) > 1 else free
        used: list[int] = []
        picks: list[tuple[int, int]] = []
        for r in shards:
            d = b.dem[r]
            key = (int(b.part[r]) if b.part[r] >= 0 else -1, int(b.req[r]))
            idx = members.get(key)
            if idx is None:
                mask = snap.part == key[0] if key[0] >= 0 else np.ones(len(snap.part), bool)
                if key[1]:
                    mask &= (snap.feat & key[1]) == key[1]
                idx = members[key] = np.nonzero(mask)[0]
            top = most.get(key)
            if top is None:
                top = most[key] = (free[idx].max(axis=0) if idx.size
                                   else np.full(free.shape[1], -np.inf, free.dtype))
            if (d > top).any():
                picks = []
                break
            sub = trial[idx]
            mask = np.all(sub >= d, axis=1)
            if used:
                mask &= ~np.isin(idx, used)
            cand = np.nonzero(mask)[0]
            if cand.size == 0:
                picks = []
                break
            pick = int(idx[cand[np.argmin(sub[cand, 0] - d[0])]])
            trial[pick] -= d
            picks.append((r, pick))
            if len(shards) > 1:
                used.append(pick)
        if len(picks) == len(shards):
            free = trial
            most.clear()
            for r, pick in picks:
                node_of[r] = pick
    return node_of


def free_after(snap: Snapshot, b: Batch, node_of: np.ndarray) -> np.ndarray:
    free = snap.free.astype(np.float64)
    for r in np.nonzero(node_of >= 0)[0]:
        free[node_of[r]] -= b.dem[r]
    return free.astype(np.float32)


# ---- the admission fast path -------------------------------------------------


class FastPath:
    """The fast path's window between two solves: the solve's residual
    (each placed shard's demand rounded up to whole units, as Slurm
    allocates), protected unplaced gangs, and the tight-fit guarded
    admission of one eligible arrival at a time."""

    def __init__(self, snap: Snapshot, residual: np.ndarray, backlog: list[tuple[Job, int]]):
        self.snap = snap
        self.free = residual.astype(np.float32).copy()
        self.protected = []
        for job, rank in backlog:
            need, d = shard_demand(job)
            part = snap.part_codes.get(job.partition, -1)
            if need <= 1 or part < 0:
                continue
            d = d.astype(np.float32)
            mask = self._feasible(d, part, req_bits(job, snap))
            if int(mask.sum()) < need:
                continue
            self.protected.append(dict(need=need, rank=rank, d=d, mask=mask,
                                       count=int(mask.sum())))

    def _feasible(self, d, part, req) -> np.ndarray:
        return ((self.snap.part == part) & (self.free >= d).all(1)
                & ((np.uint32(req) & ~self.snap.feat) == 0))

    def admit(self, job: Job) -> tuple[str, ...] | None:
        """The chosen node names of an eligible job, or None on a miss;
        a bind debits the window. Ineligible jobs return None too."""
        if max(1, job.nodes) > MAX_FAST_GANG:
            return None
        rank = CLASS_RANKS[job_class(job)]
        if rank not in INTERACTIVE_RANKS:
            return None
        need, d = shard_demand(job)
        part = self.snap.part_codes.get(job.partition, -1)
        if part < 0:
            return None
        d = np.ceil(d.astype(np.float32))
        free = self.free
        cands = np.nonzero(self._feasible(d, part, req_bits(job, self.snap)))[0]
        if cands.size < need:
            return None
        cands = cands[np.argsort(free[cands, 0] - d[0], kind="stable")]
        chosen, hits = [], []
        for n in cands[:max(need, FAST_NODE_TRIES)].tolist():
            bad, n_hits = False, []
            for g in self.protected:
                if not g["mask"][n]:
                    continue
                if not (free[n] - d >= g["d"]).all():
                    if g["rank"] >= rank and g["count"] >= g["need"] and g["count"] - 1 < g["need"]:
                        bad = True
                        break
                    n_hits.append(g)
            if bad:
                continue
            free[n] -= d
            for g in n_hits:
                g["mask"] = g["mask"].copy()
                g["mask"][n] = False
                g["count"] -= 1
            hits.extend((g, n) for g in n_hits)
            chosen.append(n)
            if len(chosen) == need:
                break
        if len(chosen) < need:
            for n in chosen:
                free[n] += d
            for g, n in hits:
                g["mask"] = g["mask"].copy()
                g["mask"][n] = True
                g["count"] += 1
            return None
        return tuple(self.snap.names[i] for i in chosen)


def window_residual(snap: Snapshot, b: Batch, node_of: np.ndarray) -> np.ndarray:
    """The fast path's base after a solve: its free capacity with each
    placed shard's demand rounded up to whole units."""
    res = free_after(snap, b, node_of).astype(np.float32)
    for r in np.nonzero(node_of >= 0)[0]:
        res[node_of[r]] -= np.ceil(b.dem[r]) - b.dem[r]
    return res


# ---- the mirror ---------------------------------------------------------------

TERMINAL = {"COMPLETED", "CANCELLED", "FAILED", "TIMEOUT"}
BAD_END = {"CANCELLED", "FAILED", "TIMEOUT"}


def pod_phase(states: list[str]) -> str:
    """The pod phase a list of Slurm job states mirrors to."""
    if not states:
        return "Pending"
    if all(s in TERMINAL for s in states):
        return "Failed" if any(s in BAD_END for s in states) else "Succeeded"
    if "RUNNING" in states:
        return "Running"
    if any(s in BAD_END for s in states):
        return "Failed"
    if "PENDING" in states:
        return "Pending"
    return "Unknown"
