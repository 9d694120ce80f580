"""Multi-device auction sweep over a ("dp", "mp") grid of blocks.

The P×N score/choose work — the only part that scales with the product of
queue size and cluster size — is split both ways: each block owns a
[P/dp, N/mp] slice and scores it every round through the ``bid_argmax``
kernel (:mod:`..ops.bid_argmax`) with its global row and node offsets, so
the jitter hash and the returned node ids are the single-block solve's.
Everything O(P) or O(N) (admission sort, pricing, gang bookkeeping) is
computed once per process on its first block's device, so per round:

- free capacity comes from the replicated assignment (no traffic);
- the "mp" combine picks each row's best (value, node) over its row's node
  blocks — the first block wins a tie, as the lowest index does inside one;
- the "dp" gather puts the rows' choices back into one [P] vector; with a
  process group (:mod:`..parallel.distributed`) it crosses the ranks in
  rank order, and every rank ends with the same assignment.

Padding: P is padded to a multiple of dp with rows whose partition code
can never match (2**30), N to a multiple of mp with nodes advertising -1
free capacity — unchoosable by construction. A block's node order for the
kernel files its pad nodes under code -1 (the rows of any partition alone
walk them, and fail their capacity test), so the order stays dense.

Replaces ``slurm_bridge_tpu/solver/sharded.py`` (``shard_map``); every step
of a round is the JAX package's, and :func:`sharded_place` equals its
``sharded_place`` on the same inputs and grid shape.
"""

from __future__ import annotations

import numpy as np
import torch

from slurm_bridge_tpu_torch.ops.bid_argmax import bid_argmax, node_order, row_order
from slurm_bridge_tpu_torch.parallel.mesh import SolverMesh, pad_to_multiple, solver_mesh
from slurm_bridge_tpu_torch.solver.auction import (
    AuctionConfig,
    admit_preordered,
    batch_has_gangs,
    dense_score_choose,
    gang_dedup,
    gang_revoke,
    multi_mask,
    normalize_gangs,
    price_step,
    prio_rank_order,
    repair_unplaced,
    resolve_kernel,
    resource_scale,
    to_device,
    used_capacity,
)
from slurm_bridge_tpu_torch.solver.snapshot import ClusterSnapshot, JobBatch, Placement

_PAD_PART = np.int32(2**30)


class _Block:
    """One grid entry's constant operands: its rows' and nodes' slices on
    its device, and for the kernel its node and row orders (built once per
    solve, reused every round)."""

    def __init__(self, i, j, device, pblk, nblk, host, *, cfg, n_total, dtype, use_kernel):
        self.device = device
        self.cfg, self.n_total, self.dtype, self.use_kernel = cfg, n_total, dtype, use_kernel
        self.p_off, self.n_off = i * pblk, j * nblk
        rows = slice(self.p_off, self.p_off + pblk)
        nodes = slice(self.n_off, self.n_off + nblk)
        self.rows, self.nodes = rows, nodes
        part = host["node_part"][nodes]
        self.node_part = to_device(part, np.int32, device)
        self.node_feat = to_device(host["node_feat"][nodes], np.int32, device)
        self.dem = to_device(host["dem"][rows], np.float32, device)
        self.job_part = to_device(host["job_part"][rows], np.int32, device)
        self.req_feat = to_device(host["req_feat"][rows], np.int32, device)
        self.incumbent = to_device(host["inc"][rows], np.int32, device)
        self.scale = to_device(host["scale"], np.float32, device)
        self.dem_n = (self.dem * self.scale).to(dtype)
        self.order = self.row_ids = None
        if use_kernel:
            self.order = node_order(np.where(part == _PAD_PART, -1, part), device)
            self.row_ids = row_order(self.job_part)

    def score(self, free, price, unplaced, rnd):
        """This block's (best value, global node) per row for round ``rnd``."""
        cfg = self.cfg
        free_blk = free[self.nodes].to(self.device)
        price_blk = price[self.nodes].to(self.device)
        if self.use_kernel:
            return bid_argmax(
                free_blk, self.node_part, self.node_feat, price_blk,
                self.dem, self.job_part, self.req_feat, self.incumbent,
                self.dem_n, free_blk * self.scale, rnd,
                p_base=self.p_off, n_base=self.n_off,
                jitter=cfg.jitter, affinity_weight=cfg.affinity_weight,
                num_nodes=self.n_total, live=unplaced[self.rows].to(self.device),
                nodes=self.order, rows=self.row_ids,
            )
        lidx, lval = dense_score_choose(
            free_blk, price_blk, self.dem, self.dem_n, self.job_part,
            self.req_feat, self.node_part, self.node_feat, self.incumbent, rnd,
            jitter=cfg.jitter, affinity_weight=cfg.affinity_weight, dtype=self.dtype,
            scale=self.scale, p_off=self.p_off, n_off=self.n_off,
        )
        return lval, lidx + self.n_off


def combine_blocks(vals, nodes, home, group=None):
    """The round's two gathers: over "mp", each row's best block (``vals``
    and ``nodes`` are this process's rows' [mp] lists of [P/dp] tensors, in
    dp then mp order; ``torch.argmax`` takes the first maximum, so the
    lowest block wins a tie), then over "dp" the rows back into one [P]
    value and choice vector on ``home`` — across the ranks of ``group`` in
    rank order. gloo's gather runs through host memory."""
    bval, bchoice = [], []
    for row_v, row_n in zip(vals, nodes):
        v = torch.stack([x.to(home) for x in row_v])
        c = torch.stack([x.to(home) for x in row_n])
        w = v.argmax(dim=0, keepdim=True)
        bval.append(v.gather(0, w)[0])
        bchoice.append(c.gather(0, w)[0])
    bval, bchoice = torch.cat(bval), torch.cat(bchoice)
    if group is None:
        return bval, bchoice
    import torch.distributed as dist

    via = torch.device("cpu") if dist.get_backend(group) == "gloo" else home
    world = dist.get_world_size(group)
    out = []
    for t in (bval, bchoice):
        t = t.to(via)
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t, group=group)
        out.append(torch.cat(parts).to(home))
    return out[0], out[1]


def sharded_place(
    snapshot: ClusterSnapshot,
    batch: JobBatch,
    config: AuctionConfig | None = None,
    *,
    mesh: SolverMesh | None = None,
    incumbent: np.ndarray | None = None,
    device=None,
) -> Placement:
    """Solve one tick over the blocks of ``mesh`` (default: every device
    this process — and each rank of a process group — solves on).
    ``device`` names the backend (None is the card, or ``SBT_BACKEND=cpu``;
    ``"cpu"`` the host): the score/choose goes through the kernel on
    ``cuda``, float32, unless ``use_pallas=False``; otherwise each block
    runs the plain dense score, the JAX package's jnp block path."""
    from slurm_bridge_tpu_torch.parallel.backend import ensure_backend

    backend = ensure_backend(device)
    cfg = config or AuctionConfig()
    mesh = mesh or solver_mesh(backend=backend)
    use_kernel = resolve_kernel(cfg, backend, 0)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    dp, mp = mesh.shape["dp"], mesh.shape["mp"]

    p_real = batch.num_shards
    n_real = snapshot.num_nodes
    free0, _ = pad_to_multiple(snapshot.free, mp, value=-1.0)
    node_part, _ = pad_to_multiple(snapshot.partition_of, mp, value=_PAD_PART)
    node_feat, _ = pad_to_multiple(snapshot.features, mp)
    n = free0.shape[0]
    dem, _ = pad_to_multiple(batch.demand, dp)
    job_part, _ = pad_to_multiple(batch.partition_of, dp, value=_PAD_PART)
    req_feat, _ = pad_to_multiple(batch.req_features, dp)
    prio, _ = pad_to_multiple(batch.priority, dp, value=np.float32(-1e30))
    # pad rows get fresh singleton gang ids so they never merge; real ids
    # are remapped onto [0, p_real): the segment ops index by them, so raw
    # persistent ids (streaming churn grows them without bound) never do
    p = dem.shape[0]
    gang = np.arange(p, dtype=np.int32)
    gang[:p_real] = normalize_gangs(batch.gang_id)
    inc = np.full(p, -1, dtype=np.int32)
    if incumbent is not None:
        inc[:p_real] = incumbent
    has_gangs = batch_has_gangs(gang[:p_real])
    host = dict(
        node_part=node_part, node_feat=node_feat, dem=dem, job_part=job_part,
        req_feat=req_feat, inc=inc, scale=resource_scale(snapshot),
    )

    import torch.distributed as dist

    mine = mesh.local_rows(dist.get_rank(mesh.group) if mesh.group is not None else 0)
    pblk, nblk = p // dp, n // mp
    blocks = [
        [_Block(i, j, mesh.devices[i, j], pblk, nblk, host, cfg=cfg, n_total=n,
                dtype=dtype, use_kernel=use_kernel)
         for j in range(mp)]
        for i in mine
    ]
    # the replicated control path, once per process on its first block's device
    home = mesh.devices[mine[0], 0]
    free0_t = to_device(free0, np.float32, home)
    dem_t = to_device(dem, np.float32, home)
    gang_t = to_device(gang, np.int64, home)
    scale = to_device(host["scale"], np.float32, home)
    prio_t = to_device(prio, np.float32, home)
    multi = multi_mask(gang_t, p) if has_gangs else torch.zeros(p, dtype=torch.bool, device=home)
    prio_eff = prio_t + multi.to(torch.float32) * (
        1e4 if cfg.gang_first and has_gangs else 0.0
    )
    dem_n = (dem_t * scale).to(dtype)
    salvage_start = cfg.rounds - min(cfg.gang_salvage_rounds, max(0, cfg.rounds - 1))
    prio_order = prio_rank_order(prio_eff)

    assign = torch.full((p,), -1, dtype=torch.int32, device=home)
    price = torch.zeros(n, dtype=torch.float32, device=home)
    for rnd in range(cfg.rounds):
        if has_gangs and rnd >= salvage_start:
            assign = gang_revoke(assign, gang_t, p)
        free = free0_t - used_capacity(dem_t, assign, n)
        unplaced = assign < 0
        vals, nodes = [], []
        for row in blocks:
            scored = [b.score(free, price, unplaced, rnd) for b in row]
            vals.append([v for v, _ in scored])
            nodes.append([c for _, c in scored])
        bval, choice = combine_blocks(vals, nodes, home, mesh.group)
        valid = unplaced & torch.isfinite(bval)
        choice = torch.where(valid, choice, n).to(torch.int32)
        if has_gangs:
            choice, valid = gang_dedup(choice, valid, assign, gang_t, multi, n)
        admitted = admit_preordered(choice, valid, dem_t, prio_order, free, n)
        assign = torch.where(
            admitted & unplaced, torch.where(choice < n, choice, -1), assign
        )
        price = price_step(price, choice, valid, dem_n, free, scale, n, cfg.eta)
    if has_gangs:
        assign = gang_revoke(assign, gang_t, p)
    free_after = free0_t - used_capacity(dem_t, assign, n)

    assign_np = assign.cpu().numpy()[:p_real]
    # pad rows can never place (impossible partition), pad nodes can never
    # be chosen (negative free); strip both and we are done
    placement = Placement(
        node_of=assign_np,
        placed=assign_np >= 0,
        free_after=free_after.cpu().numpy()[:n_real],
    )
    if cfg.repair:
        placement = repair_unplaced(snapshot, batch, placement, incumbent=incumbent)
    return placement
