"""Fixed-iteration auction sweep — the placement solve, in PyTorch.

One reconcile tick = one call. The solve is a fixed number of identical
rounds (a Python loop, no data-dependent control flow), each fully
vectorised over all pending shards:

1. **score/choose**: per-shard argmax over nodes of a deterministic
   round-salted hash jitter, minus a per-node congestion *price*, plus an
   optional demand-weighted best-fit affinity, masked by feasibility
   (capacity ∧ partition ∧ feature bits ∧ incumbent pin). On the card this
   is the hand-written ``bid_argmax`` kernel (:mod:`..ops.bid_argmax`);
   the dense branch below is its plain version at solve level, and the
   sampled branch bids on K hash-drawn candidates per shard;
2. **dedup**: shards of one gang must land on distinct nodes;
3. **admit**: per-node priority-ordered prefix admission — one stable sort
   by (chosen node, −priority) plus a segmented cumulative demand;
4. **price**: nodes that were over-requested raise their price;
5. **gangs**: after the last round, incompletely placed gangs are revoked
   and free capacity is recomputed from the surviving assignment.

Determinism: same inputs → same assignment, on every run and on either
device. The jitter is an integer hash of global indices; every float sum
runs in a fixed order — segment sums in row order without atomics
(:func:`segment_sum`), the admission scan in the reference's association
order (:func:`segmented_cumsum`), row sums left to right.

Every function mirrors its namesake in the JAX package's
``solver/auction.py`` on the same inputs; the tests hold them equal.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from slurm_bridge_tpu_torch.ops.bid_argmax import (
    affinity_fma, bid_argmax, fma_f32, mix, node_order, row_order, unit,
)
from slurm_bridge_tpu_torch.solver.snapshot import ClusterSnapshot, JobBatch, Placement

log = logging.getLogger("sbt.auction")

_M32 = 0xFFFFFFFF
_NEG_INF = float("-inf")


@dataclass(frozen=True)
class AuctionConfig:
    """Knobs for the auction sweep — the JAX package's fields and defaults,
    one for one.

    ``jitter`` is the primary *spreader*: a pod-independent best-fit score
    makes every pod agree on the same tightest node and serialises the
    solve, so the deterministic hash noise does the fan-out and
    ``affinity_weight`` applies best-fit only as a mild bias on top.
    """

    rounds: int = 8
    eta: float = 0.5  # price step (bids are O(1))
    jitter: float = 1.0  # spread amplitude (the dominant bid term)
    #: the final K rounds begin by revoking incomplete gangs, so capacity a
    #: doomed gang was sitting on gets re-bid while rounds remain
    gang_salvage_rounds: int = 2
    #: admit multi-shard gangs ahead of singles regardless of priority
    #: (hardest-to-place-first); opt-in, because it breaks strict priority
    #: order between a gang and a higher-priority single
    gang_first: bool = False
    #: best-fit bias relative to jitter
    affinity_weight: float = 0.0
    #: candidate sampling ("power of K choices"): each shard bids on K
    #: hash-sampled nodes from its own (partition, feature) pool instead of
    #: all N. ``None`` = auto (full argmax on the card, where the kernel
    #: runs; sampled K=64 elsewhere once P·N ≥ 2**25); ``0`` = force full;
    #: ``K>0`` = force sampled with K candidates.
    candidates: int | None = None
    #: host-side post-solve repair: re-admit whatever stayed unplaced with
    #: the exact indexed packer. Placements are only added, never moved.
    repair: bool = True
    dtype: str = "float32"  # score dtype ("bfloat16" for the plain paths)
    #: score/choose through the hand-written kernel (``ops/bid_argmax``)
    #: instead of the dense plain branch. ``None`` = auto: on for the
    #: ``cuda`` backend. float32 only: with ``dtype="bfloat16"`` the solve
    #: falls back to the dense branch rather than ignore the dtype.
    use_pallas: bool | None = None


def hash_jitter(
    p: int, n: int, salt: int, dtype=torch.float32, *, p_off: int = 0,
    n_off: int = 0, device,
) -> torch.Tensor:
    """Deterministic pseudo-random [P, N] in [0, 1) from index hashing —
    a pure function of *global* indices (``p_off``/``n_off`` + local) and
    the round ``salt``, bit-identical to the JAX package and the kernel."""
    pi = (torch.arange(p, device=device) + p_off) & _M32
    ni = (torch.arange(n, device=device) + n_off) & _M32
    return unit(mix(pi[:, None], ni[None, :], salt), dtype)


def _combine(a_v, a_f, b_v, b_f):
    return torch.where(b_f, b_v, a_v + b_v), a_f | b_f


def _assoc_scan(v: torch.Tensor, f: torch.Tensor):
    """Inclusive scan of :func:`_combine` with ``jax.lax.associative_scan``'s
    own recursion (pairwise reduce, recurse, fix up the evens, interleave),
    so every float add has the same operands as in the reference."""
    n = v.shape[0]
    if n < 2:
        return v, f
    r_v, r_f = _combine(v[0:-1:2], f[0:-1:2], v[1::2], f[1::2])
    o_v, o_f = _assoc_scan(r_v, r_f)
    if n % 2 == 0:
        e_v, e_f = _combine(o_v[:-1], o_f[:-1], v[2::2], f[2::2])
    else:
        e_v, e_f = _combine(o_v, o_f, v[2::2], f[2::2])
    out_v = torch.empty_like(v)
    out_f = torch.empty_like(f)
    out_v[0], out_f[0] = v[0], f[0]
    out_v[2::2], out_f[2::2] = e_v, e_f
    out_v[1::2], out_f[1::2] = o_v, o_f
    return out_v, out_f


def segmented_cumsum(values: torch.Tensor, segment_change: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of ``values`` [P, R] restarting where
    ``segment_change`` [P] is True (True at each segment's first row).

    A true segmented scan, NOT global-cumsum-minus-base: a global float32
    running total over 50k shards reaches ~1e9 where the ulp is ~64, and
    the subtraction would carry that error into per-node admission. Every
    accumulation here stays bounded by one node's total demand.
    """
    out, _ = _assoc_scan(values, segment_change[:, None])
    return out


def segment_sum(
    values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sum the rows of ``values`` by segment, each segment in row order —
    ``((v_a + v_b) + v_c) + …``, the order of XLA's CPU scatter-add — so
    the float result is the same on every device and every run. (A plain
    ``index_add_`` on CUDA adds colliding rows with atomics in a different
    order each run; here no launch adds to one cell twice.)

    Rows where ``mask`` is False are left out: the reference adds them as
    +0.0, which changes no sum of non-negative terms.
    """
    out = values.new_zeros((num_segments, *values.shape[1:]))
    seg = segment_ids.long()
    if mask is not None:
        keep = torch.nonzero(mask).squeeze(1)
        values, seg = values[keep], seg[keep]
    if seg.numel() == 0:
        return out
    # rank of each row within its segment, then rows grouped by rank: the
    # k-th add of every segment happens in one index_add_ whose indices
    # are distinct, so no cell sees two adds at once
    order = torch.sort(seg, stable=True).indices
    s_sorted = seg[order]
    counts = torch.bincount(seg, minlength=num_segments)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(seg.numel(), device=seg.device) - starts[s_sorted]
    by_rank = torch.sort(rank, stable=True).indices
    seg_r = s_sorted[by_rank]
    val_r = values[order][by_rank]
    off = 0
    for cnt in torch.bincount(rank).tolist():
        out.index_add_(0, seg_r[off : off + cnt], val_r[off : off + cnt])
        off += cnt
    return out


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis left to right (XLA's reduce order)."""
    out = x[..., 0]
    for r in range(1, x.shape[-1]):
        out = out + x[..., r]
    return out


def used_capacity(dem: torch.Tensor, assign: torch.Tensor, n: int) -> torch.Tensor:
    """[N, R] capacity consumed by the current assignment (stateless)."""
    return segment_sum(dem, assign.clamp(0, n - 1), n, mask=assign >= 0)


def _multi_key_order(*keys: torch.Tensor) -> torch.Tensor:
    """Stable ascending order by lexicographic ``keys``: chained stable
    sorts, last key first. ``lax.sort`` orders floats totally (−0.0 before
    +0.0) and ``torch.sort`` does not; the one float key is ``-prio_eff``,
    whose zeros are all −0.0 (``prio + 0.0`` turns −0.0 into +0.0 first),
    so the two orders agree on every input the solve builds."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        order = order[torch.sort(key[order], stable=True).indices]
    return order


def gang_dedup(choice, valid, assign, gang, multi, n):
    """Enforce distinct-nodes within a gang: among shards of one gang
    targeting the same node this round (or a node a sibling already holds),
    only the first keeps its choice. Returns updated (choice, valid)."""
    unplaced = assign < 0
    eff = torch.where(assign >= 0, assign, choice)  # node or sentinel n
    # primary key gang, then node, with already-placed rows sorting first
    order = _multi_key_order(gang, (eff << 1) | unplaced.to(torch.int32))
    g_s = gang[order]
    e_s = eff[order]
    same = (g_s[1:] == g_s[:-1]) & (e_s[1:] == e_s[:-1])
    dup_s = torch.cat([same.new_zeros(1), same]) & (e_s < n) & multi[order]
    dup = torch.empty_like(dup_s)
    dup[order] = dup_s
    valid = valid & ~dup
    return torch.where(valid, choice, n), valid


def dense_score_choose(
    free, price, dem, dem_n, job_part, req_feat, node_part, node_feat,
    incumbent, rnd, *, jitter, affinity_weight, dtype, scale,
    chunk_cells: int = 1 << 24, p_off: int = 0, n_off: int = 0,
):
    """The full [P, N] score/choose — the reference's dense round body, in
    row chunks of at most ``chunk_cells`` cells so no [P, N] array is ever
    whole. ``p_off``/``n_off`` place a block of the sweep (:mod:`sharded`)
    at its global rows and nodes: the jitter hash and the incumbent pin see
    global indices, the returned choice is local. Returns (choice [P] i32,
    best [P]).

    In float32 the bid is rounded as the reference's round is on the CPU,
    where XLA fuses each multiply into the add after it: with affinity
    ``fma(hash, jitter, w·(−aff)) − price`` over the fused 3-term chain
    (:func:`affinity_fma`, :func:`fma_f32`), the kernel's arithmetic;
    without, ``hash·jitter − price``. Another ``dtype`` keeps the
    reference's expression unfused, with the affinity as a matrix product."""
    p, n = dem.shape[0], free.shape[0]
    device = dem.device
    free_n = (free * scale).to(dtype)
    nf = node_feat.long() & _M32
    node_ids = torch.arange(n, device=device) + n_off
    price_d = price.to(dtype)
    fused = bool(affinity_weight) and dtype == torch.float32
    # the fused affinity holds a few float64 [rows, N] temporaries
    rows = max(1, (chunk_cells // 8 if fused else chunk_cells) // max(n, 1))
    choice = torch.empty(p, dtype=torch.int32, device=device)
    best = torch.empty(p, dtype=torch.float32, device=device)
    for a in range(0, p, rows):
        s = slice(a, min(a + rows, p))
        jp = job_part[s, None]
        rf = req_feat[s, None].long() & _M32
        inc = incumbent[s, None]
        part_ok = (jp == node_part[None, :]) | (jp < 0)
        feat_ok = (nf[None, :] & rf) == rf
        static_ok = part_ok & feat_ok
        static_ok = torch.where(inc >= 0, (node_ids[None, :] == inc) & static_ok, static_ok)
        cap_ok = (dem[s, None, :] <= free[None, :, :] + 1e-6).all(-1)
        feasible = static_ok & cap_ok
        h = hash_jitter(s.stop - a, n, rnd, dtype, p_off=p_off + a, n_off=n_off, device=device)
        if fused:
            aff = affinity_fma(dem_n[s, None, :], free_n[None, :, :])
            bid = fma_f32(h, jitter, affinity_weight * -aff)
        elif affinity_weight:
            bid = affinity_weight * -(dem_n[s] @ free_n.T) + h * jitter
        else:
            bid = h * jitter
        bid = bid - price_d[None, :]
        bid = torch.where(feasible, bid, _NEG_INF)
        c = bid.argmax(dim=1)
        choice[s] = c.to(torch.int32)
        best[s] = bid.gather(1, c[:, None])[:, 0].float()
    return choice, best


def sampled_score_choose(
    free, price, dem, dem_n, job_part, req_feat,
    node_part, node_feat, incumbent,
    part_order, samp_start, samp_count, rnd,
    *, candidates, jitter, affinity_weight, dtype, scale,
    check_feats: bool = True,
):
    """One power-of-K-choices score/choose step: each shard draws K
    candidate nodes from its (partition, feature) slice of ``part_order``
    and bids only on those — O(P·K) instead of O(P·N). Returns (choice
    [P] i32, best [P]).

    In float32 the bid is rounded as the reference's sampled round is on
    the CPU, where XLA fuses ``hash·jitter − price`` into one fused
    multiply-add, the 3-term affinity into the fused chain and ``+ w·aff``
    into another: ``fma(w, −aff, fma(hash, jitter, −price))``
    (:func:`fma_f32`, :func:`affinity_fma`). So at ``affinity_weight=0`` a
    candidate's bid is what the full [P, N] path scores for the same
    (shard, node, round) only at ``jitter=1``, as in the reference."""
    p = dem.shape[0]
    device = dem.device
    inc = incumbent >= 0
    pi = torch.arange(p, device=device)[:, None]
    ki = torch.arange(candidates, device=device)[None, :]
    salt = rnd & _M32
    # independent stream from the bid jitter (different salt mix)
    draw = mix(pi, ki, (salt * 0x68E31DA4 + 0x1B56C4E9) & _M32)
    cnt = samp_count.clamp_min(1).long()
    idx = samp_start[:, None].long() + draw % cnt[:, None]
    pool_hi = part_order.shape[0] - 1  # pool is longer than N
    cand = part_order[idx.clamp(0, pool_hi)]  # [P, K] node ids
    cand = torch.where(inc[:, None], incumbent[:, None], cand)
    has_cand = (samp_count > 0) | inc
    freec = free[cand]  # [P, K, R] gather
    cap_ok_k = (dem[:, None, :] <= freec + 1e-6).all(-1)
    feas = has_cand[:, None] & cap_ok_k
    # draws come from the shard's own partition slice, so no per-candidate
    # partition check; incumbent-substituted candidates do NOT come from
    # the pools and are re-validated explicitly
    rf = req_feat.long() & _M32
    nf = node_feat.long() & _M32
    inc_node = incumbent.clamp(0, node_part.shape[0] - 1)
    inc_feas = ((job_part == node_part[inc_node]) | (job_part < 0)) & (
        (nf[inc_node] & rf) == rf
    )
    feas &= (~inc | inc_feas)[:, None]
    if check_feats:
        feas &= (nf[cand] & rf[:, None]) == rf[:, None]
    jit_k = unit(mix(pi, cand.long() & _M32, salt), dtype)
    price_k = price[cand].to(dtype)
    if dtype == torch.float32:
        bid = fma_f32(jit_k, jitter, -price_k)
        if affinity_weight:
            aff = -affinity_fma(dem_n[:, None, :], freec * scale)
            bid = fma_f32(affinity_weight, aff, bid)
    else:
        bid = jit_k * jitter - price_k
        if affinity_weight:
            aff = -(dem_n[:, None, :] * (freec * scale).to(dtype)).sum(-1)
            bid = bid + affinity_weight * aff
    bid = torch.where(feas, bid, _NEG_INF)
    kbest = bid.argmax(dim=1)[:, None]
    choice = cand.gather(1, kbest)[:, 0]
    best = bid.gather(1, kbest)[:, 0].float()
    return choice, best


def prio_rank_order(prio: torch.Tensor) -> torch.Tensor:
    """Priority-descending stable row order — constant across rounds, so
    each round's admission sorts by ONE int key (a stable primary-key sort
    over secondary-preordered rows IS the lexicographic order)."""
    return _multi_key_order(-prio)


def admit_preordered(choice, valid, dem, prio_order, free, n):
    """Per-node priority-ordered prefix admission over rows pre-sorted by
    :func:`prio_rank_order`. Returns admitted [P] bool."""
    sub = _multi_key_order(choice[prio_order])
    order = prio_order[sub]
    c_sorted = choice[order]
    d_sorted = torch.where(valid[order, None], dem[order], 0.0)
    seg_first = torch.cat(
        [c_sorted.new_ones(1, dtype=torch.bool), c_sorted[1:] != c_sorted[:-1]]
    )
    within = segmented_cumsum(d_sorted, seg_first)  # [P, R]
    free_of_choice = torch.where(
        (c_sorted < n)[:, None], free[c_sorted.clamp(0, n - 1)], 0.0
    )
    admit_sorted = (within <= free_of_choice + 1e-6).all(dim=1) & (c_sorted < n)
    admitted = torch.empty_like(admit_sorted)
    admitted[order] = admit_sorted
    return admitted & valid


def admit(choice, valid, dem, prio, free, n):
    """Per-node priority-ordered prefix admission. Returns admitted [P] bool."""
    return admit_preordered(choice, valid, dem, prio_rank_order(prio), free, n)


def price_step(price, choice, valid, dem_n, free, scale, n, eta):
    """Congestion pricing: nodes requested beyond capacity get pricier.

    ``log1p`` is taken in float64 and rounded once to float32, so the step
    is correctly rounded and the same on the CPU and the card. XLA's
    float32 ``log1p`` is not correctly rounded, so a price may differ from
    the JAX package's by an ulp (within rtol 1e-6)."""
    req = segment_sum(dem_n.float(), choice.clamp(0, n - 1), n, mask=valid)
    have = _row_sum(free * scale).clamp_min(1e-6)
    oversub = _row_sum(req) / have
    step = torch.log1p((oversub - 1.0).clamp_min(0.0).double()).float()
    return price + eta * step


def gang_revoke(assign: torch.Tensor, gang: torch.Tensor, p: int) -> torch.Tensor:
    """All-or-nothing: revoke every shard of gangs not fully placed.
    Integer segment sums: exact in any order."""
    gang_sz = torch.bincount(gang, minlength=p)
    gang_placed = torch.bincount(gang[assign >= 0], minlength=p)
    complete = (gang_placed == gang_sz)[gang]
    return torch.where(complete, assign, -1)


def multi_mask(gang: torch.Tensor, p: int) -> torch.Tensor:
    """[P] bool — True for shards belonging to a multi-shard gang."""
    gang_sz = torch.bincount(gang, minlength=max(p, 1))
    return gang_sz[gang] > 1


def _auction_kernel(
    free0,  # [N, R] f32
    node_part,  # [N] i32
    node_feat,  # [N] i32 (uint32 bits)
    dem,  # [P, R] f32
    job_part,  # [P] i32
    req_feat,  # [P] i32 (uint32 bits)
    prio,  # [P] f32
    gang,  # [P] i64 (values < P)
    scale,  # [R] f32 resource normalisers
    incumbent,  # [P] i32 node currently held (-1 = free agent)
    part_order,  # [M] i32 node indices grouped by partition (sampled mode)
    samp_start,  # [P] i32 shard's slice start into part_order (sampled mode)
    samp_count,  # [P] i32 shard's slice length (sampled mode; 0 = no nodes)
    nodes=None,  # kernel path: node_order(node_part) — built here if None
    *,
    rounds: int,
    num_nodes: int,
    eta: float = AuctionConfig.eta,
    jitter: float = AuctionConfig.jitter,
    affinity_weight: float = AuctionConfig.affinity_weight,
    dtype=torch.float32,
    use_pallas: bool = False,
    gang_salvage_rounds: int = AuctionConfig.gang_salvage_rounds,
    gang_first: bool = AuctionConfig.gang_first,
    candidates: int = 0,
    has_gangs: bool = True,
    check_feats: bool = True,
):
    """The R-round auction on tensors of one device. Returns
    (assign [P] i32, free_after [N, R] f32) on that device.

    ``use_pallas`` sends score/choose through the hand-written kernel
    (on CPU tensors, its plain version), which scores only the rows still
    unplaced; ``candidates > 0`` takes the
    sampled branch; otherwise the dense branch runs. ``has_gangs=False``
    skips the dedup sort and the revoke sums."""
    p = dem.shape[0]
    n = num_nodes

    dem_n = (dem * scale).to(dtype)  # [P, R] normalised demand
    multi = multi_mask(gang, p) if has_gangs else torch.zeros(p, dtype=torch.bool, device=dem.device)
    # admission-ordering priority; only the solve sees the gang-first boost
    prio_eff = prio + multi.to(torch.float32) * (1e4 if gang_first and has_gangs else 0.0)
    salvage_start = rounds - min(gang_salvage_rounds, max(0, rounds - 1))
    prio_order = prio_rank_order(prio_eff)  # constant: hoisted out of the loop

    assign = torch.full((p,), -1, dtype=torch.int32, device=dem.device)
    price = torch.zeros(n, dtype=torch.float32, device=dem.device)
    if use_pallas and candidates == 0 and dem.device.type == "cuda":
        # the kernel's work list: node and row orders are fixed for the solve
        nodes = nodes if nodes is not None else node_order(node_part, dem.device)
        rows = row_order(job_part)
    else:
        nodes = rows = None
    for rnd in range(rounds):
        # salvage phase: incomplete gangs release their capacity up front
        if has_gangs and rnd >= salvage_start:
            assign = gang_revoke(assign, gang, p)
        free = free0 - used_capacity(dem, assign, n)

        if candidates > 0:
            choice, best = sampled_score_choose(
                free, price, dem, dem_n, job_part, req_feat,
                node_part, node_feat, incumbent,
                part_order, samp_start, samp_count, rnd,
                candidates=candidates, jitter=jitter,
                affinity_weight=affinity_weight, dtype=dtype, scale=scale,
                check_feats=check_feats,
            )
        elif use_pallas:
            # the hand-written kernel: no [P, N] intermediates anywhere, and
            # only the unplaced rows scored — the same rows `valid` keeps
            best, choice = bid_argmax(
                free, node_part, node_feat, price,
                dem, job_part, req_feat, incumbent,
                dem * scale, free * scale, rnd,
                jitter=jitter, affinity_weight=affinity_weight, num_nodes=n,
                live=assign < 0, nodes=nodes, rows=rows,
            )
        else:
            choice, best = dense_score_choose(
                free, price, dem, dem_n, job_part, req_feat,
                node_part, node_feat, incumbent, rnd,
                jitter=jitter, affinity_weight=affinity_weight, dtype=dtype,
                scale=scale,
            )
        unplaced = assign < 0
        valid = unplaced & torch.isfinite(best)
        choice = torch.where(valid & (choice < n), choice, n).to(torch.int32)

        if has_gangs:
            choice, valid = gang_dedup(choice, valid, assign, gang, multi, n)
        admitted = admit_preordered(choice, valid, dem, prio_order, free, n)
        assign = torch.where(
            admitted & unplaced, torch.where(choice < n, choice, -1), assign
        )
        price = price_step(price, choice, valid, dem_n, free, scale, n, eta)

    if has_gangs:
        assign = gang_revoke(assign, gang, p)
    return assign, free0 - used_capacity(dem, assign, n)


#: P·N work above which the auto path switches to candidate sampling when
#: the hand kernel does not run (any backend but ``cuda``).
SAMPLING_MIN_WORK = 1 << 25


def resolve_candidates(config: AuctionConfig, backend: str, p: int, n: int) -> int:
    """Resolve ``AuctionConfig.candidates`` (None = auto) to a concrete K.

    ``"cuda"`` takes the place the JAX package gives ``"tpu"``: the full
    argmax, through the kernel. An explicit ``use_pallas=True`` wins over
    auto-sampling (the caller is validating the kernel)."""
    if config.candidates is not None:
        return max(0, int(config.candidates))
    if config.use_pallas:
        return 0
    if backend != "cuda" and p * n >= SAMPLING_MIN_WORK:
        return 64
    return 0


class CandidatePools:
    """Per-snapshot candidate pools for the sampled path.

    Each shard draws its K candidates from a contiguous slice of one flat
    int32 array, conditioned on everything cheap to condition on:

    - shards with no feature requirement draw from their partition's slice
      of the base order (``job_part < 0`` ⇒ the whole cluster);
    - shards requiring feature bits draw from a (partition, bit) pool —
      nodes of that partition carrying the shard's lowest required bit —
      built lazily per distinct combo and appended to the flat array.
      Remaining bits of a multi-bit mask are still checked per candidate.

    The flat array grows only when a never-seen (partition, bit) combo
    appears; its length is padded to a multiple of N.
    """

    def __init__(self, snapshot: ClusterSnapshot):
        self.n = snapshot.num_nodes
        self._node_part = snapshot.partition_of
        self._node_feat = snapshot.features
        order = np.argsort(snapshot.partition_of, kind="stable").astype(np.int32)
        self._sorted_parts = snapshot.partition_of[order]
        self._concat = order  # base order occupies [0, N)
        self._offsets: dict[tuple[int, int], tuple[int, int]] = {}
        #: bumped whenever ``array`` content/length changes (device restage)
        self.version = 0
        self._padded: np.ndarray | None = None

    @property
    def array(self) -> np.ndarray:
        """The flat pool array, zero-padded to a multiple of N."""
        if self._padded is None:
            n = max(1, self.n)
            total = ((len(self._concat) + n - 1) // n) * n
            self._padded = np.zeros(total, np.int32)
            self._padded[: len(self._concat)] = self._concat
        return self._padded

    def _feature_pool(self, pc: int, bit: int) -> tuple[int, int]:
        """(start, count) of the pool for partition ``pc`` (−1 = any) and
        feature ``bit`` — built and appended on first use."""
        key = (pc, bit)
        hit = self._offsets.get(key)
        if hit is not None:
            return hit
        mask = (self._node_feat >> np.uint32(bit)) & np.uint32(1) == 1
        if pc >= 0:
            mask &= self._node_part == pc
        ids = np.nonzero(mask)[0].astype(np.int32)
        off = (len(self._concat), len(ids))
        self._concat = np.concatenate([self._concat, ids])
        self._offsets[key] = off
        self._padded = None
        self.version += 1
        return off

    def slices(self, batch: JobBatch) -> tuple[np.ndarray, np.ndarray]:
        """Per-shard (start, count) into :attr:`array`. An empty slice
        (unknown partition, PAD_PARTITION, a bit no node carries, reserved
        bit 31) can never place — the full path's masks say the same."""
        jp = batch.partition_of
        start = np.searchsorted(self._sorted_parts, jp, side="left")
        end = np.searchsorted(self._sorted_parts, jp, side="right")
        anyp = jp < 0
        start = np.where(anyp, 0, start).astype(np.int32)
        count = np.where(anyp, self.n, end - start).astype(np.int32)
        req = batch.req_features
        sel = np.nonzero(req != 0)[0]
        if sel.size:
            m = req[sel].astype(np.int64)
            impossible = (m >> 31) != 0  # reserved sentinel: unplaceable
            low = (m & -m).astype(np.float64)
            bits = np.where(impossible, 0, np.log2(low).astype(np.int64))
            combos = jp[sel].astype(np.int64) * 64 + bits  # distinct pairs
            uniq, inverse = np.unique(combos, return_inverse=True)
            table = np.empty((len(uniq), 2), np.int64)
            for i, c in enumerate(uniq):
                table[i] = self._feature_pool(int(c // 64), int(c % 64))
            start[sel] = table[inverse, 0]
            count[sel] = np.where(impossible, 0, table[inverse, 1])
        return start, count


def resource_scale(snapshot: ClusterSnapshot) -> np.ndarray:
    """Per-resource normaliser: 1 / mean per-node capacity (keeps the
    normalised affinity terms O(1) against the jitter)."""
    mean_cap = snapshot.capacity.mean(axis=0) if snapshot.num_nodes else np.ones(3)
    return (1.0 / np.maximum(mean_cap, 1.0)).astype(np.float32)


def normalize_gangs(gang: np.ndarray) -> np.ndarray:
    """Remap arbitrary gang ids onto [0, P) — the solve uses them as
    segment ids and the native packer as array indices."""
    if gang.size == 0:
        return gang.astype(np.int32)
    _, inverse = np.unique(gang, return_inverse=True)
    return inverse.astype(np.int32)


def batch_needs_feat_check(req_features: np.ndarray) -> bool:
    """True if any required-feature mask carries more than one bit — the
    only case the sampled path's per-candidate feature check narrows."""
    if req_features.size == 0:
        return False
    r = req_features.astype(np.uint32)
    return bool(np.any((r & (r - np.uint32(1))) != 0))


def batch_has_gangs(gang_norm: np.ndarray) -> bool:
    """True if any gang spans more than one shard."""
    if gang_norm.size == 0:
        return False
    return bool(np.bincount(gang_norm).max() > 1)


def bits_i32(a: np.ndarray) -> np.ndarray:
    """uint32 feature masks as int32 bit patterns (the device tensors'
    type: the same bits, and torch's integer ops all take int32)."""
    return np.ascontiguousarray(a, dtype=np.uint32).view(np.int32)


def repair_unplaced(
    snapshot: ClusterSnapshot,
    batch: JobBatch,
    placement: Placement,
    *,
    incumbent: np.ndarray | None = None,
) -> Placement:
    """One host-side repair pass over a solve result (AuctionConfig.repair).

    Jobs the auction left wholly unplaced are re-admitted against
    ``free_after`` with the exact indexed packer. Gangs containing an
    incumbent-pinned shard are skipped: their keep-or-preempt verdict
    belongs to the solve, and a partial re-place would break all-or-nothing.
    """
    unplaced = ~placement.placed & (batch.job_of >= 0)  # pad rows never place
    if incumbent is not None and (incumbent >= 0).any():
        pinned_gangs = np.unique(batch.gang_id[incumbent >= 0])
        unplaced &= ~np.isin(batch.gang_id, pinned_gangs)
    if not unplaced.any():
        return placement
    rows = np.nonzero(unplaced)[0]
    sub = batch.select(rows)
    residual = ClusterSnapshot(
        node_names=snapshot.node_names,
        capacity=snapshot.capacity,
        free=placement.free_after,
        partition_of=snapshot.partition_of,
        features=snapshot.features,
        partition_codes=snapshot.partition_codes,
        feature_codes=snapshot.feature_codes,
    )
    from slurm_bridge_tpu_torch.solver.indexed_native import indexed_place_native

    rp = indexed_place_native(residual, sub)
    if not rp.placed.any():
        return placement
    node_of = placement.node_of.copy()
    node_of[rows] = np.where(rp.placed, rp.node_of, node_of[rows])
    return Placement(
        node_of=node_of, placed=node_of >= 0, free_after=rp.free_after
    )


def resolve_kernel(config: AuctionConfig, backend: str, k: int) -> bool:
    """Whether score/choose goes through the hand kernel: auto (``None``)
    means on for ``cuda``; never on the sampled path; never with a
    non-float32 dtype (the kernel is float32-only — warned, not ignored)."""
    use = config.use_pallas if k == 0 else False
    if use is None:
        use = backend == "cuda"
    if use and config.dtype != "float32":
        log.warning(
            "use_pallas with dtype=%r is unsupported — using the plain dense path",
            config.dtype,
        )
        use = False
    return bool(use)


def to_device(a: np.ndarray, dtype, device) -> torch.Tensor:
    """A copy of ``a`` as ``dtype`` on ``device`` — a copy on the CPU too,
    because callers mutate snapshot and batch arrays in place. uint32
    feature masks go as their int32 bit patterns (:func:`bits_i32`)."""
    if dtype == np.int32 and np.asarray(a).dtype == np.uint32:
        a = bits_i32(a)
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def stage_batch(batch: JobBatch, incumbent: np.ndarray, device) -> dict:
    """The per-solve (queue-side) tensors on ``device``."""
    gang_norm = normalize_gangs(batch.gang_id)
    return dict(
        dem=to_device(batch.demand, np.float32, device),
        job_part=to_device(batch.partition_of, np.int32, device),
        req_feat=to_device(batch.req_features, np.int32, device),
        prio=to_device(batch.priority, np.float32, device),
        gang=to_device(gang_norm, np.int64, device),
        incumbent=to_device(incumbent, np.int32, device),
        has_gangs=batch_has_gangs(gang_norm),
    )


def auction_place(
    snapshot: ClusterSnapshot,
    batch: JobBatch,
    config: AuctionConfig | None = None,
    *,
    incumbent: np.ndarray | None = None,
    device: str | torch.device | None = None,
) -> Placement:
    """Solve one tick on ``device`` (default: the card; ``"cpu"`` or
    ``SBT_BACKEND=cpu`` for the host — see :mod:`..parallel.backend`).

    ``incumbent`` ([P] int32, -1 = none) marks shards already holding a node
    for the streaming-reschedule path; ``snapshot.free`` must then reflect
    capacity with those incumbents' usage released.
    """
    from slurm_bridge_tpu_torch.parallel.backend import ensure_backend

    cfg = config or AuctionConfig()
    backend = ensure_backend(device)
    if batch.num_shards == 0 or snapshot.num_nodes == 0:
        return Placement(
            node_of=np.full(batch.num_shards, -1, np.int32),
            placed=np.zeros(batch.num_shards, bool),
            free_after=snapshot.free.copy(),
        )
    if incumbent is None:
        incumbent = np.full(batch.num_shards, -1, np.int32)
    dev = torch.device(backend)
    k = resolve_candidates(cfg, backend, batch.num_shards, snapshot.num_nodes)
    use_kernel = resolve_kernel(cfg, backend, k)
    if k > 0:
        pools = CandidatePools(snapshot)
        samp_start, samp_count = pools.slices(batch)
        order = pools.array
    else:  # unused by the full path — 1-element placeholders
        order = samp_start = samp_count = np.zeros(1, np.int32)
    q = stage_batch(batch, incumbent, dev)
    nodes = node_order(snapshot.partition_of, dev) if use_kernel and dev.type == "cuda" else None
    assign, free_after = _auction_kernel(
        to_device(snapshot.free, np.float32, dev),
        to_device(snapshot.partition_of, np.int32, dev),
        to_device(snapshot.features, np.int32, dev),
        q["dem"], q["job_part"], q["req_feat"], q["prio"], q["gang"],
        to_device(resource_scale(snapshot), np.float32, dev),
        q["incumbent"],
        to_device(order, np.int32, dev),
        to_device(samp_start, np.int32, dev),
        to_device(samp_count, np.int32, dev),
        nodes,
        rounds=cfg.rounds,
        num_nodes=snapshot.num_nodes,
        eta=cfg.eta,
        jitter=cfg.jitter,
        affinity_weight=cfg.affinity_weight,
        dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
        use_pallas=use_kernel,
        gang_salvage_rounds=cfg.gang_salvage_rounds,
        gang_first=cfg.gang_first,
        candidates=k,
        has_gangs=q["has_gangs"],
        check_feats=k > 0 and batch_needs_feat_check(batch.req_features),
    )
    assign_np = assign.cpu().numpy()
    placement = Placement(
        node_of=assign_np,
        placed=assign_np >= 0,
        free_after=free_after.cpu().numpy(),
    )
    if cfg.repair:
        placement = repair_unplaced(
            snapshot, batch, placement, incumbent=incumbent
        )
    return placement
