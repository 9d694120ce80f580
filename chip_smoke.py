#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port's placement solve.

    python3 chip_smoke.py

Needs one CUDA card (Hopper, ``sm_90a``) and ``nvcc``; exits non-zero
without one. Imports nothing of JAX or of the JAX package. Phases, each of
which fails the run:

1. identify the card (``nvidia-smi`` name and power limit);
2. build ``slurm_bridge_tpu_torch/csrc/bid_argmax.cu`` from the checkout;
3. hold the kernel against its plain PyTorch version on the card: small
   shapes, a tie across a tile boundary, one round's operands of the
   57,635 × 10,000 headline solve, and every round of one instrumented
   headline solve with that round's live mask (the rows still unplaced) —
   bit-exact at ``affinity_weight=0``; at 0.3, ≥ 99.9 % equal choices and
   values within atol 1e-5. Per round it prints the live rows, the cells
   they need (each live row's partition's node count) and the kernel's
   device time in the solve (CUDA events around the wrapper's call, behind
   a gate so the host's launch rate is not timed); then the time per launch
   on all rows, and two bounds on the needed cells: the roofline at the
   data sheet's rates, and the per-pipe issue ceiling at the SM clock
   ``nvidia-smi`` reads while the kernel runs;
4. drive the main path at full width: ``choose_path`` must route the
   headline scenario to the device; ``DeviceSolver`` (rounds=8) solves it
   1 + 5 times, once through ``solve_async``, and once more after a node
   is drained; every solve must launch the kernel exactly 8 times, be
   feasible, and be deterministic; its ``node_of`` digest must equal the
   JAX package's (:data:`HEADLINE_REFERENCE`); the dense plain path on the
   card must place identically;
5. hold the card against the JAX package's result on a reduced scenario
   (``tools/port_reference.py``): placed jobs within 0.5 %, digest shown;
6. print times with the card's name and power limit.

The second-to-last lines are the kernels' JSON record and the
``nvidia-smi`` line; the last line is the run's JSON verdict.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

#: The headline scenario (57,635 shards × 10,000 nodes, 4 partitions,
#: 15 % GPU nodes, 5 % of jobs as 4-node gangs) and the solve's config.
HEADLINE = dict(num_nodes=10_000, num_jobs=50_000, seed=42, load=0.7,
                gpu_fraction=0.15, gang_fraction=0.05)
ROUNDS = 8

#: The JAX package's dense solve of the reduced scenario on the CPU, from
#: ``JAX_PLATFORMS=cpu python tools/port_reference.py --nodes 5000 --jobs 25000``
#: (a quarter of the headline's cells).
REFERENCE = dict(nodes=5000, jobs=25000, shards=28837, placed_jobs=22780,
                 node_of_sha256="968124f92cadbd7b5d47e629b7d0530ad83e6752926d736c68e116ea31fd76b4")
#: The JAX package's dense solve of the headline scenario on the CPU, from
#: ``JAX_PLATFORMS=cpu python tools/port_reference.py --nodes 10000 --jobs 50000``.
#: Every headline solve on the card must give this ``node_of``.
HEADLINE_REFERENCE = dict(placed_jobs=45479, placed_shards=52307,
                          node_of_sha256="b6a4f8a8afea3192637cc0709c51544669a0e8be5195cdcf733ba7fca316ebcd")

#: Peak rates for the bound (NVIDIA H100 SXM data sheet): HBM bytes/s and
#: float32 non-tensor-core operations/s. Counting every integer and float
#: operation of the cell loop at the f32 rate gives a least time.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
#: Per-SM issue rates in lanes per clock (CUDA C++ programming guide,
#: arithmetic instruction throughput, compute capability 9.0): 32-bit
#: integer add/logic/compare, f32 add/multiply/compare, type conversion,
#: shared-memory loads; and the total a Hopper SM issues (four schedulers,
#: one warp instruction each). The H100 SXM has 132 SMs.
LANES_PER_CLOCK = dict(int=64, f32=128, cvt=16, lds=32)
ISSUE_LANES_PER_CLOCK = 128
SMS = 132


class SmokeFailure(RuntimeError):
    """A phase of the smoke run found the port wrong."""


def require(ok, msg) -> None:
    """Fail the run (an explicit check: ``assert`` vanishes under -O)."""
    if not ok:
        raise SmokeFailure(str(msg))


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


#: Cycles of a spin kernel queued ahead of a timed window (~0.2 s at the
#: H100's 1.98 GHz): the host enqueues the whole window while the device
#: spins, so the events time the device's work and not the host's launch
#: rate. A window whose enqueue outlasted the gate is measured again.
GATE_CYCLES = 400_000_000
GATE_TRIES = 3


def cuda_ms(fn, reps: int, gate: bool = True) -> float:
    """Mean device time per call over ``reps`` calls, from CUDA events
    behind a :data:`GATE_CYCLES` gate (``gate=False`` for a call that
    launches more kernels than the launch queue holds; time it only where
    the device, not the host, is the limit)."""
    for _ in range(GATE_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if gate:
            torch.cuda._sleep(GATE_CYCLES)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        host_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        gate_s = (time.perf_counter() - t0) - start.elapsed_time(stop) / 1e3
        if not gate or host_s < gate_s:
            return start.elapsed_time(stop) / reps
        log(f"  (host enqueue {host_s:.3f} s outlasted the {gate_s:.3f} s gate: timing again)")
    raise SmokeFailure("every timing window's enqueue outlasted its gate")


def digest(node_of: np.ndarray) -> str:
    return hashlib.sha256(node_of.astype("<i4").tobytes()).hexdigest()


def check_feasible(snap, batch, pl) -> None:
    """Capacity, partition, features, gang all-or-nothing and distinct
    nodes within a gang."""
    placed = pl.placed
    nodes = pl.node_of[placed]
    require((nodes >= 0).all() and (nodes < snap.num_nodes).all(), "bad node id")
    used = np.zeros(snap.free.shape, np.float64)
    np.add.at(used, nodes, batch.demand[placed])
    require((used <= snap.free + 1e-3).all(), "node oversubscribed")
    jp = batch.partition_of[placed]
    require(((jp < 0) | (snap.partition_of[nodes] == jp)).all(), "wrong partition")
    rf = batch.req_features[placed]
    require(((snap.features[nodes] & rf) == rf).all(), "missing features")
    _, gang = np.unique(batch.gang_id, return_inverse=True)
    size = np.bincount(gang)
    got = np.bincount(gang, weights=placed.astype(np.float64))
    require(((got == 0) | (got == size)).all(), "gang partially placed")
    multi = placed & (size[gang] > 1)
    pairs = gang[multi].astype(np.int64) * (snap.num_nodes + 1) + pl.node_of[multi]
    require(np.unique(pairs).size == int(multi.sum()), "gang co-located")


def round_operands(snap, batch, device, seed=7):
    """One round's kernel operands of the headline solve: the snapshot's
    free capacity, a seeded price vector, the batch's demands."""
    from slurm_bridge_tpu_torch.solver.auction import resource_scale, to_device

    rng = np.random.default_rng(seed)
    scale = resource_scale(snap)
    return [
        to_device(snap.free, np.float32, device),
        to_device(snap.partition_of, np.int32, device),
        to_device(snap.features, np.int32, device),
        to_device(rng.uniform(0, 0.5, snap.num_nodes), np.float32, device),
        to_device(batch.demand, np.float32, device),
        to_device(batch.partition_of, np.int32, device),
        to_device(batch.req_features, np.int32, device),
        to_device(np.full(batch.num_shards, -1), np.int32, device),
        to_device(batch.demand * scale, np.float32, device),
        to_device(snap.free * scale, np.float32, device),
    ]


def small_operands(seed, n, p, device):
    rng = np.random.default_rng(seed)
    free = rng.uniform(0, 64, (n, 3)).astype(np.float32)
    dem = rng.uniform(0, 32, (p, 3)).astype(np.float32)
    scale = np.float32(1.0) / np.maximum(free.mean(0), 1)
    arrays = [
        free, rng.integers(0, 4, n).astype(np.int32), rng.integers(0, 4, n).astype(np.int32),
        rng.uniform(0, 1, n).astype(np.float32), dem, rng.integers(-1, 4, p).astype(np.int32),
        rng.integers(0, 4, p).astype(np.int32),
        np.where(rng.random(p) < 0.3, rng.integers(0, n, p), -1).astype(np.int32),
        (dem * scale).astype(np.float32), (free * scale).astype(np.float32),
    ]
    return [torch.from_numpy(a).to(device) for a in arrays]


def compare(kern, args, salt, aw, n, label, live=None, **plain_kw):
    """Kernel vs plain on the same operands; returns the max |Δ| over
    finite values. Bit-exact at aw=0; the stated tolerance at aw≠0."""
    kw = dict(jitter=1.0, affinity_weight=aw, num_nodes=n, live=live)
    bv, bi = kern.bid_argmax(*args, salt, **kw)
    torch.cuda.synchronize()
    pv, pi = kern.bid_argmax_plain(*args, salt, **kw, **plain_kw)
    same_idx = (bi == pi).float().mean().item()
    fin = torch.isfinite(pv)
    require(torch.equal(torch.isfinite(bv), fin), f"{label}: feasibility differs")
    err = (bv[fin] - pv[fin]).abs().max().item() if fin.any() else 0.0
    exact = torch.equal(bi, pi) and torch.equal(bv.view(torch.int32), pv.view(torch.int32))
    log(f"  {label} aw={aw}: choices equal {same_idx:.6f}, max|dv| {err:.3g}, bit-exact {exact}")
    if aw == 0.0:
        require(exact, f"{label}: kernel and plain differ at affinity_weight=0")
    else:
        require(same_idx >= 0.999 and err <= 1e-5, f"{label}: outside tolerance")
    return err


def needed_cells(node_part: np.ndarray, job_part: np.ndarray, live: np.ndarray) -> int:
    """Cells the kernel's inputs need: for each live row, the nodes of its
    partition (every node for a row of any partition)."""
    per_part = np.bincount(node_part[node_part >= 0]) if (node_part >= 0).any() else np.zeros(0, int)
    jp = job_part[live].astype(np.int64)
    known = (jp >= 0) & (jp < per_part.size)
    per_row = np.where(jp < 0, node_part.size, 0)
    per_row[known] = per_part[jp[known]]
    return int(per_row.sum())


def bounds(kern, cells: int, nbytes: int, sm_hz: float):
    """(roofline ms, what bounds it, per-pipe issue ceiling ms) for
    ``cells`` needed cells and ``nbytes`` of operands."""
    ops = kern.OPS_PER_CELL * cells
    roof_s = max(nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S)
    bound_by = "operations" if ops / ALU_OPS_PER_S > nbytes / HBM_BYTES_PER_S else "bytes"
    c = kern.CELL_OPS
    clocks_per_cell = max(
        max(c[k] / LANES_PER_CLOCK[k] for k in LANES_PER_CLOCK),
        sum(c.values()) / ISSUE_LANES_PER_CLOCK,
    )
    ceiling_s = cells * clocks_per_cell / SMS / sm_hz
    return roof_s * 1e3, bound_by, ceiling_s * 1e3


def sm_clock_mhz(busy) -> float:
    """The highest SM clock ``nvidia-smi`` samples while ``busy()`` runs."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )
    try:
        time.sleep(0.3)
        busy()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    vals = [float(v) for v in out.split() if v.replace(".", "", 1).isdigit()]
    require(vals, "nvidia-smi read no SM clock")
    return max(vals)


def instrumented_solve(snap, batch):
    """One headline ``DeviceSolver.solve`` with CUDA events around each
    call of the kernel's wrapper (behind a short gate, so they time the
    device's work: the wrapper's work list, node packing, scoring and
    finish), keeping each round's operands and live mask. Returns
    (placement, rounds)."""
    import slurm_bridge_tpu_torch.solver.auction as auction_mod
    from slurm_bridge_tpu_torch.solver import AuctionConfig, DeviceSolver

    real = auction_mod.bid_argmax
    rounds = []

    def recorder(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(GATE_CYCLES // 10)  # the gate of cuda_ms: device time only
        start.record()
        out = real(*args, **kw)
        stop.record()
        rounds.append(dict(args=[a.clone() for a in args[:10]], salt=args[10],
                           live=kw["live"].clone(), kw=kw, events=(start, stop)))
        return out

    auction_mod.bid_argmax = recorder
    try:
        pl = DeviceSolver(snap, AuctionConfig(rounds=ROUNDS)).solve(batch)
    finally:
        auction_mod.bid_argmax = real
    torch.cuda.synchronize()
    for r in rounds:
        r["ms"] = r["events"][0].elapsed_time(r["events"][1])
    return pl, rounds


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import slurm_bridge_tpu_torch.ops.bid_argmax as kern
    from slurm_bridge_tpu_torch.parallel.backend import ensure_backend
    from slurm_bridge_tpu_torch.solver import AuctionConfig, DeviceSolver, auction_place
    from slurm_bridge_tpu_torch.solver.routing import choose_path, gang_shard_fraction
    from slurm_bridge_tpu_torch.solver.snapshot import random_scenario

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. the card
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"[1] card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {name}")

    # 2. build
    t0 = time.perf_counter()
    out = kern.build(force=True)
    ptxas = [ln.strip() for ln in out.splitlines() if "ptxas" in ln or "registers" in ln]
    log(f"[2] built {kern._LIB.name} in {time.perf_counter() - t0:.1f} s")
    for ln in ptxas:
        log(f"  {ln}")

    # 3. kernel vs plain
    log("[3] kernel vs plain version on the card")
    errs = []
    for n, p in ((700, 300), (33, 1000), (1, 1)):
        args = small_operands(n * 1000 + p, n, p, dev)
        for aw in (0.0, 0.3):
            errs.append(compare(kern, args, 7, aw, n, f"({n},{p})"))
    tie = small_operands(1, 600, 260, dev)
    tie[0][:] = 100.0
    tie[0][:127] = 0.0
    tie[4][:] = 1.0
    tie[5][:] = -1
    tie[6][:] = 0
    tie[7][:] = -1
    tie[3][:] = 0.25
    bv, bi = kern.bid_argmax(*tie, 1, jitter=0.0, affinity_weight=0.0, num_nodes=600)
    pv, pi = kern.bid_argmax_plain(*tie, 1, jitter=0.0, affinity_weight=0.0, num_nodes=600)
    require((bi == 127).all() and torch.equal(bi, pi) and torch.equal(bv, pv), "tie rule")
    log("  tie across the kernel's tile boundary: node 127 wins everywhere")

    snap, batch = random_scenario(**HEADLINE)
    p_h, n_h = batch.num_shards, snap.num_nodes
    require((p_h, n_h) == (57_635, 10_000), (p_h, n_h))
    hargs = round_operands(snap, batch, dev)
    for aw in (0.0, 0.3):
        errs.append(compare(kern, hargs, 3, aw, n_h, f"headline ({n_h},{p_h})", bp=4096, bn=2048))

    # every round of one headline solve, with that round's live mask
    node_part_np, job_part_np = snap.partition_of, batch.partition_of
    inst_pl, rounds = instrumented_solve(snap, batch)
    require(len(rounds) == ROUNDS, f"{len(rounds)} kernel calls in the instrumented solve")
    require(digest(inst_pl.node_of) == HEADLINE_REFERENCE["node_of_sha256"],
            "instrumented solve's node_of differs from the JAX package's")
    solve_cells, solve_ms = [], []
    for i, r in enumerate(rounds):
        live_np = r["live"].cpu().numpy()
        cells = needed_cells(node_part_np, job_part_np, live_np)
        errs.append(compare(kern, r["args"], r["salt"], 0.0, n_h, f"headline round {i}",
                            live=r["live"], bp=4096, bn=2048))
        solve_cells.append(cells)
        solve_ms.append(r["ms"])
        log(f"  round {i}: live rows {int(live_np.sum())}, needed cells {cells}, "
            f"kernel {r['ms']:.4f} ms in the solve [{smi}]")
    ms_per_solve = sum(solve_ms)
    log(f"  per solve: {sum(solve_cells)} needed cells, kernel {ms_per_solve:.4f} ms over "
        f"{ROUNDS} calls [{smi}]")

    # time per launch on all rows of one round's operands, plain beside it;
    # node and row orders built once, as the solve builds them
    hk = dict(jitter=1.0, affinity_weight=0.0, num_nodes=n_h,
              nodes=kern.node_order(snap.partition_of, dev), rows=kern.row_order(hargs[5]))
    for _ in range(3):
        kern.bid_argmax(*hargs, 3, **hk)
    kernel_ms = cuda_ms(lambda: kern.bid_argmax(*hargs, 3, **hk), 20)
    pk = dict(jitter=1.0, affinity_weight=0.0, num_nodes=n_h, bp=4096, bn=2048)
    kern.bid_argmax_plain(*hargs, 3, **pk)
    plain_ms = cuda_ms(lambda: kern.bid_argmax_plain(*hargs, 3, **pk), 2, gate=False)

    def busy():
        end = time.perf_counter() + 1.5
        while time.perf_counter() < end:
            for _ in range(20):
                kern.bid_argmax(*hargs, 3, **hk)
            torch.cuda.synchronize()

    sm_mhz = sm_clock_mhz(busy)
    all_live = np.ones(p_h, bool)
    cells = needed_cells(node_part_np, job_part_np, all_live)
    bytes_moved = 4 * 9 * (n_h + p_h) + p_h + 8 * p_h  # operands, live mask, outputs
    bound_ms, bound_by, ceiling_ms = bounds(kern, cells, bytes_moved, sm_mhz * 1e6)
    solve_bound_ms, _, solve_ceiling_ms = bounds(kern, sum(solve_cells), ROUNDS * bytes_moved,
                                                 sm_mhz * 1e6)
    log(f"  all rows live: kernel {kernel_ms:.4f} ms/launch, plain {plain_ms:.1f} ms; "
        f"{cells} needed cells (of {p_h * n_h} dense); bound {bound_ms:.4f} ms ({bound_by}, "
        f"{kern.OPS_PER_CELL} ops/cell at {ALU_OPS_PER_S:.3g}/s), issue ceiling {ceiling_ms:.4f} ms "
        f"at SM clock {sm_mhz:.0f} MHz [{smi}]")
    log(f"  per solve: kernel {ms_per_solve:.4f} ms, bound {solve_bound_ms:.4f} ms, issue ceiling "
        f"{solve_ceiling_ms:.4f} ms [{smi}]")

    # 4. the main path at full width
    log("[4] main path: DeviceSolver on the headline scenario")
    backend = ensure_backend()
    path = choose_path(p_h, n_h, backend_name=backend,
                       gang_fraction=gang_shard_fraction(batch.gang_id))
    require(backend == "cuda" and path == "device", (backend, path))
    cfg = AuctionConfig(rounds=ROUNDS)
    kern.LAUNCHES = 0
    aux_before = kern.AUX_LAUNCHES
    solver = DeviceSolver(snap, cfg)
    results, wall_ms = [], []
    for i in range(6):  # 1 warm-up + 5 timed
        before = kern.LAUNCHES
        t0 = time.perf_counter()
        pl = solver.solve(batch)
        dt = (time.perf_counter() - t0) * 1e3
        require(kern.LAUNCHES - before == ROUNDS, f"{kern.LAUNCHES - before} launches in a solve")
        if i:
            wall_ms.append(dt)
        results.append(pl)
    before = kern.LAUNCHES
    pl_async = solver.solve_async(batch).result()
    require(kern.LAUNCHES - before == ROUNDS, f"{kern.LAUNCHES - before} launches in a solve")
    results.append(pl_async)
    drained_snap = random_scenario(**HEADLINE)[0]
    busiest = int(np.bincount(results[0].node_of[results[0].placed], minlength=n_h).argmax())
    drained_snap.free[busiest] = 0.0
    solver.update_snapshot(drained_snap)
    before = kern.LAUNCHES
    pl_drained = solver.solve(batch)
    require(kern.LAUNCHES - before == ROUNDS, f"{kern.LAUNCHES - before} launches in a solve")
    main_launches = kern.LAUNCHES
    require(main_launches == ROUNDS * 8, main_launches)

    for pl in results:
        check_feasible(snap, batch, pl)
        np.testing.assert_array_equal(pl.node_of, results[0].node_of)
    require(digest(results[0].node_of) == HEADLINE_REFERENCE["node_of_sha256"],
            f"headline node_of digest {digest(results[0].node_of)} differs from the JAX package's")
    check_feasible(drained_snap, batch, pl_drained)
    require(not (pl_drained.node_of == busiest).any(), "drained node still used")
    headline = results[0]
    placed_jobs = len(headline.by_job(batch))
    require((placed_jobs, int(headline.placed.sum())) == (
        HEADLINE_REFERENCE["placed_jobs"], HEADLINE_REFERENCE["placed_shards"]), placed_jobs)
    log(f"  {len(results)} solves identical and feasible; placed jobs {placed_jobs} "
        f"({int(headline.placed.sum())}/{p_h} shards); node_of digest equals the JAX "
        f"package's ({HEADLINE_REFERENCE['node_of_sha256'][:16]}…); drained node {busiest} "
        f"unused (placed jobs {len(pl_drained.by_job(batch))}); helper launches "
        f"{kern.AUX_LAUNCHES - aux_before}")

    dense = auction_place(snap, batch, AuctionConfig(rounds=ROUNDS, use_pallas=False, candidates=0))
    np.testing.assert_array_equal(dense.node_of, headline.node_of)
    log("  dense plain path on the card places identically")

    # 5. the JAX package's result on the reduced scenario
    ref_snap, ref_batch = random_scenario(
        REFERENCE["nodes"], REFERENCE["jobs"], seed=42, load=0.7,
        gpu_fraction=0.15, gang_fraction=0.05,
    )
    require(ref_batch.num_shards == REFERENCE["shards"], ref_batch.num_shards)
    ref_pl = DeviceSolver(ref_snap, AuctionConfig(rounds=ROUNDS, candidates=0)).solve(ref_batch)
    check_feasible(ref_snap, ref_batch, ref_pl)
    ref_jobs = len(ref_pl.by_job(ref_batch))
    rel = abs(ref_jobs - REFERENCE["placed_jobs"]) / REFERENCE["placed_jobs"]
    match = digest(ref_pl.node_of) == REFERENCE["node_of_sha256"]
    log(f"[5] reduced scenario {REFERENCE['nodes']}x{REFERENCE['jobs']}: placed jobs {ref_jobs} "
        f"vs JAX {REFERENCE['placed_jobs']} (rel {rel:.5f}); node_of digest matches JAX: {match}")
    require(rel <= 0.005, rel)

    # 6. times
    p50 = statistics.median(wall_ms)
    log(f"[6] [{smi}] headline solve p50 {p50:.1f} ms over {len(wall_ms)} "
        f"(min {min(wall_ms):.1f}, max {max(wall_ms):.1f}); kernel {kernel_ms:.4f} ms/launch "
        f"(bound {bound_ms:.4f}, ceiling {ceiling_ms:.4f}), {ms_per_solve:.4f} ms per solve; "
        f"total run {time.perf_counter() - t_start:.0f} s")

    print(json.dumps({"kernels": [{
        "name": "bid_argmax",
        "route": "cuda",
        "source": "slurm_bridge_tpu_torch/csrc/bid_argmax.cu",
        "replaces": "slurm_bridge_tpu/ops/bid_argmax.py:78",
        "launches": main_launches,
        "max_abs_err": max(errs),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "ms_per_solve": ms_per_solve,
        "ceiling_ms": ceiling_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
