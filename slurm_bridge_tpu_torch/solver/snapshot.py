"""Lowering cluster state and pending jobs into dense solver matrices.

The reference advertises capacity per partition by summing node cpus/mem/gpus
(pkg/slurm-virtual-kubelet/node.go:169-199) and places pods one at a time.
Here the whole inventory becomes one ``[N, R]`` matrix and the pending queue
one ``[P, R]`` matrix so a single batched sweep places everything at once.

Encoding decisions (accelerator-first):
- resources are float32 columns normalised later by the solver; the dims are
  fixed and static (``RESOURCE_DIMS``) so shapes never depend on data;
- partition membership is an int32 code per row (compared, not one-hot — the
  P×N feasibility product is formed on the fly inside the kernel);
- node features are a uint32 bitmask; a job's required features must be a
  subset of its node's mask (gres strings / features per
  apis slurmbridgejob_types.go:55, agent api/slurm.go:74-78);
- multi-node jobs (``nodes>1``) are split into per-node shards sharing a
  gang id — the solver admits gangs all-or-nothing, which is also how MPI
  jobsets (BASELINE config #4) are expressed.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np

from slurm_bridge_tpu_torch.core.arrays import array_len
from slurm_bridge_tpu_torch.core.types import JobDemand, NodeInfo, PartitionInfo
from slurm_bridge_tpu_torch.obs.metrics import REGISTRY

log = logging.getLogger("sbt.snapshot")

#: Static resource dimensions, in matrix column order.
RESOURCE_DIMS = ("cpus", "mem_mb", "gpus")
NUM_RES = len(RESOURCE_DIMS)

#: Features silently unmatchable because the 31-bit mask was already full.
#: Before this counter existed, a capacity-matching bug from a dropped
#: feature was undiagnosable (the node simply never matched).
_features_dropped = REGISTRY.counter(
    "sbt_encoder_features_dropped_total",
    "node features dropped because the 31-bit feature mask was full "
    "(the rate-limited sbt.snapshot warning names each dropped feature)",
)
_DROP_LOG_INTERVAL_S = 60.0
_last_drop_log = [0.0]


def _note_dropped_feature(feature: str) -> None:
    """Count (always) and warn (rate-limited) a feature that fell off the
    31-bit mask — the node can never match a job requiring it. The counter
    is unlabeled on purpose: drops only happen on clusters with MANY
    distinct (often machine-generated) feature strings, where a per-name
    label would grow the registry without bound; the log carries the name.
    """
    _features_dropped.inc()
    now = time.monotonic()
    if now - _last_drop_log[0] >= _DROP_LOG_INTERVAL_S:
        _last_drop_log[0] = now
        log.warning(
            "feature bitmask full (31 codes assigned): dropping %r — nodes "
            "advertising only this feature cannot match jobs requiring it "
            "(sbt_encoder_features_dropped_total counts every drop)",
            feature,
        )


@dataclass
class ClusterSnapshot:
    """Dense view of the node inventory at one tick."""

    node_names: list[str]
    capacity: np.ndarray  # [N, R] float32 total capacity
    free: np.ndarray  # [N, R] float32 free capacity
    partition_of: np.ndarray  # [N] int32 partition code
    features: np.ndarray  # [N] uint32 feature bitmask
    partition_codes: dict[str, int]  # name -> code
    feature_codes: dict[str, int]  # name -> bit index

    @property
    def num_nodes(self) -> int:
        return len(self.node_names)


@dataclass
class JobBatch:
    """Dense view of the pending queue at one tick.

    One row per *placement shard*: a single-node job is one row; an
    ``n``-node job is ``n`` rows sharing a ``gang_id``. ``job_of`` maps each
    row back to the submitting job's index in the original list.
    """

    demand: np.ndarray  # [P, R] float32 per-shard demand
    partition_of: np.ndarray  # [P] int32 partition code (-1 = any)
    req_features: np.ndarray  # [P] uint32 required feature bits
    priority: np.ndarray  # [P] float32 (higher places first)
    gang_id: np.ndarray  # [P] int32 gang group (unique per job)
    job_of: np.ndarray  # [P] int32 original job index

    @property
    def num_shards(self) -> int:
        return int(self.demand.shape[0])

    def select(self, keep: np.ndarray) -> "JobBatch":
        """Row subset (boolean mask or index array); ids are preserved —
        callers owning persistent id spaces (StreamingSim) re-key
        themselves."""
        return JobBatch(
            demand=self.demand[keep],
            partition_of=self.partition_of[keep],
            req_features=self.req_features[keep],
            priority=self.priority[keep],
            gang_id=self.gang_id[keep],
            job_of=self.job_of[keep],
        )


def concat_batches(batches: list[JobBatch]) -> JobBatch:
    """Row-wise concatenation; ids are taken as-is (callers re-key)."""
    return JobBatch(
        demand=np.concatenate([b.demand for b in batches]),
        partition_of=np.concatenate([b.partition_of for b in batches]),
        req_features=np.concatenate([b.req_features for b in batches]),
        priority=np.concatenate([b.priority for b in batches]),
        gang_id=np.concatenate([b.gang_id for b in batches]),
        job_of=np.concatenate([b.job_of for b in batches]),
    )


@dataclass
class Placement:
    """Solver output: shard→node assignment (-1 = unplaced)."""

    node_of: np.ndarray  # [P] int32
    placed: np.ndarray  # [P] bool
    free_after: np.ndarray  # [N, R] float32

    def by_job(self, batch: JobBatch) -> dict[int, list[int]]:
        """Map original job index → list of assigned node indices."""
        out: dict[int, list[int]] = {}
        for shard in np.nonzero(self.placed)[0]:
            out.setdefault(int(batch.job_of[shard]), []).append(
                int(self.node_of[shard])
            )
        return out


def node_partition_map(partitions: list[PartitionInfo]) -> tuple[dict[str, int], dict[str, int]]:
    """(partition name → code, node name → partition code). First listing
    wins for nodes in several partitions, matching the loop encoder."""
    partition_codes = {p.name: i for i, p in enumerate(partitions)}
    node_part: dict[str, int] = {}
    for p in partitions:
        for name in p.nodes:
            node_part.setdefault(name, partition_codes[p.name])
    return partition_codes, node_part


def _feature_mask(
    feats: tuple[str, ...], feature_codes: dict[str, int]
) -> int:
    """Bitmask for one node's feature tuple, assigning fresh codes in
    first-seen order. Bit 31 is reserved as the "impossible requirement"
    sentinel (_required_features) — real features stop at bit 30; once the
    table is full, extra features are unmatchable and counted as dropped."""
    mask = 0
    for f in feats:
        if f not in feature_codes:
            if len(feature_codes) >= 31:
                _note_dropped_feature(f)
                continue  # bitmask full: extra features are unmatchable
            feature_codes[f] = len(feature_codes)
        mask |= 1 << feature_codes[f]
    return mask


def node_columns(nodes: list[NodeInfo]) -> dict[str, np.ndarray]:
    """Raw per-node scalar columns as dense arrays — the scratch form both
    the vectorized encoder and the delta cache diff against. One attribute
    sweep per column; everything downstream is NumPy."""
    n = len(nodes)
    return {
        "cpus": np.fromiter((nd.cpus for nd in nodes), np.int64, n),
        "alloc_cpus": np.fromiter((nd.alloc_cpus for nd in nodes), np.int64, n),
        "mem": np.fromiter((nd.memory_mb for nd in nodes), np.int64, n),
        "alloc_mem": np.fromiter((nd.alloc_memory_mb for nd in nodes), np.int64, n),
        "gpus": np.fromiter((nd.gpus for nd in nodes), np.int64, n),
        "alloc_gpus": np.fromiter((nd.alloc_gpus for nd in nodes), np.int64, n),
    }


def node_dynamic_arrays(
    nodes: list[NodeInfo],
    cols: dict[str, np.ndarray],
    feature_codes: dict[str, int],
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(capacity [N,R] f32, free [N,R] f32, features [N] u32) from raw
    columns. State strings and feature tuples are categorical — highly
    repetitive across a cluster — so schedulability parsing and bitmask
    assembly run once per distinct value, then broadcast by NumPy take.
    """
    n = len(nodes)
    states = [nd.state for nd in nodes]
    sched_of: dict[str, bool] = {}
    for i, s in enumerate(states):
        if s not in sched_of:
            sched_of[s] = nodes[i].schedulable
    schedulable = np.fromiter((sched_of[s] for s in states), np.bool_, n)

    feats = [nd.features for nd in nodes]
    # first-seen tuple order reproduces the loop encoder's code assignment:
    # a feature's first appearance is inside the first tuple containing it
    mask_of: dict[tuple[str, ...], int] = {}
    for ft in feats:
        if ft not in mask_of:
            mask_of[ft] = _feature_mask(ft, feature_codes)
    features = np.fromiter((mask_of[ft] for ft in feats), np.uint32, n)

    capacity = np.stack(
        [cols["cpus"], cols["mem"], cols["gpus"]], axis=1
    ).astype(np.float32)
    free_int = np.stack(
        [
            np.maximum(cols["cpus"] - cols["alloc_cpus"], 0),
            np.maximum(cols["mem"] - cols["alloc_mem"], 0),
            np.maximum(cols["gpus"] - cols["alloc_gpus"], 0),
        ],
        axis=1,
    )
    free = np.where(schedulable[:, None], free_int, 0).astype(np.float32)
    return capacity, free, features


def encode_cluster(
    nodes: list[NodeInfo],
    partitions: list[PartitionInfo],
    *,
    feature_codes: dict[str, int] | None = None,
) -> ClusterSnapshot:
    """Lower NodeInfo/PartitionInfo lists into a ClusterSnapshot.

    Vectorized column build: one attribute sweep per column into dense
    scratch arrays, categorical caches for state→schedulability and
    feature-tuple→bitmask, NumPy for all row math. Bit-identical to
    :func:`encode_cluster_loop` (the kept-as-oracle reference), which the
    property tests in tests/test_solver.py pin.

    Unschedulable nodes (DRAIN/DOWN/…) keep their rows (stable indices
    across ticks — see SURVEY.md §7 determinism note) but advertise zero
    free capacity.
    """
    partition_codes, node_part = node_partition_map(partitions)
    feature_codes = dict(feature_codes or {})
    n = len(nodes)
    names = [nd.name for nd in nodes]
    cols = node_columns(nodes)
    capacity, free, features = node_dynamic_arrays(nodes, cols, feature_codes)
    partition_of = np.fromiter(
        (node_part.get(nm, -1) for nm in names), np.int32, n
    )
    return ClusterSnapshot(
        node_names=names,
        capacity=capacity,
        free=free,
        partition_of=partition_of,
        features=features,
        partition_codes=partition_codes,
        feature_codes=feature_codes,
    )


def encode_cluster_loop(
    nodes: list[NodeInfo],
    partitions: list[PartitionInfo],
    *,
    feature_codes: dict[str, int] | None = None,
) -> ClusterSnapshot:
    """The original per-row loop encoder, kept as the correctness oracle:
    the property tests assert :func:`encode_cluster` is bit-identical to
    this, and bench.py measures the vectorized+cached path against it."""
    partition_codes, node_part = node_partition_map(partitions)
    feature_codes = dict(feature_codes or {})
    n = len(nodes)
    capacity = np.zeros((n, NUM_RES), dtype=np.float32)
    free = np.zeros((n, NUM_RES), dtype=np.float32)
    partition_of = np.full(n, -1, dtype=np.int32)
    features = np.zeros(n, dtype=np.uint32)
    names = []
    for i, nd in enumerate(nodes):
        names.append(nd.name)
        capacity[i] = (nd.cpus, nd.memory_mb, nd.gpus)
        if nd.schedulable:
            free[i] = (nd.free_cpus, nd.free_memory_mb, nd.free_gpus)
        partition_of[i] = node_part.get(nd.name, -1)
        features[i] = _feature_mask(nd.features, feature_codes)
    return ClusterSnapshot(
        node_names=names,
        capacity=capacity,
        free=free,
        partition_of=partition_of,
        features=features,
        partition_codes=partition_codes,
        feature_codes=feature_codes,
    )


def _required_features(demand: JobDemand, feature_codes: dict[str, int]) -> int:
    """Map a job's constraint strings onto the snapshot's feature bits.

    A gres type (e.g. `gpu:a100:2` → "a100") participates as a feature bit
    when the cluster advertises it; unknown features make the job
    unplaceable by requiring an impossible bit (bit 31 reserved)."""
    mask = 0
    wanted: list[str] = []
    if demand.gres:
        parts = demand.gres.split(":")
        if len(parts) == 3:  # gpu:type:count
            wanted.append(parts[1])
    for feat in wanted:
        if feat in feature_codes:
            mask |= 1 << feature_codes[feat]
        else:
            mask |= 1 << 31
    return mask


def _gres_gpu_count(gres: str) -> int:
    parts = gres.split(":")
    if not parts or parts[0] != "gpu":
        return 0
    try:
        return int(parts[-1].split("(")[0])
    except ValueError:
        return 0


def job_scalars(
    demand: JobDemand, snapshot: ClusterSnapshot
) -> tuple[float, float, float, int, int, int, float]:
    """One job's shard-row scalars:
    (cpu/shard, mem/shard, gpu/shard, partition code, feature bits,
    nshards, priority). The single source of the sizecar sizing rule
    (pkg/slurm-bridge-operator/pod.go:143-162): cpu = cpus_per_task ×
    ntasks × array_len spread evenly across ``nodes`` shards; mem =
    mem_per_cpu × cpu (defaulting 1024 MB/cpu as pod.go:91-95). Shared by
    the batch encoder, the loop oracle, and the cross-tick job-row cache.
    """
    arr = array_len(demand.array)
    total_cpus = float(demand.total_cpus(arr))
    nshards = max(1, demand.nodes)
    mem_per_cpu = float(demand.mem_per_cpu_mb or 1024.0)
    cpu_per_shard = total_cpus / nshards
    # gres is a PER-NODE quantity in Slurm (--gres=gpu:4 means 4 GPUs on
    # every allocated node), so it is NOT divided across shards; the
    # array fan-out multiplies it like the sizecar cpu rule does
    gpu_per_shard = float(_gres_gpu_count(demand.gres)) * max(1, arr)
    part = snapshot.partition_codes.get(demand.partition, -1)
    feat = _required_features(demand, snapshot.feature_codes)
    return (
        cpu_per_shard,
        cpu_per_shard * mem_per_cpu,
        gpu_per_shard,
        part,
        feat,
        nshards,
        float(demand.priority),
    )


def job_scalars_batch(
    demands: list[JobDemand], snapshot: ClusterSnapshot
) -> tuple[np.ndarray, ...]:
    """:func:`job_scalars` over a demand list, vectorized — the encode
    cache's miss path (a 50k-pod cold tick is 50k first encodes). One
    Python pass touches only the stringy fields (array spec, gres), the
    arithmetic is NumPy; held value-identical to the scalar oracle by a
    fuzz test. Returns arrays in ``_JOB_COLS`` slot order:
    (cpu, mem, gpu, part, feat, nshards, prio)."""
    n = len(demands)
    cpt = np.fromiter((d.cpus_per_task for d in demands), np.int64, n)
    ntk = np.fromiter((d.ntasks for d in demands), np.int64, n)
    nod = np.fromiter((d.nodes for d in demands), np.int64, n)
    mpc = np.fromiter((d.mem_per_cpu_mb for d in demands), np.float64, n)
    prio = np.fromiter((float(d.priority) for d in demands), np.float64, n)
    arr = np.ones(n, np.int64)
    gres_rows: list[int] = []
    for i, d in enumerate(demands):
        if d.array:
            arr[i] = array_len(d.array)
        if d.gres:
            gres_rows.append(i)
    nshards = np.maximum(1, nod)
    total = (
        np.maximum(1, cpt) * np.maximum(1, ntk) * np.maximum(1, arr)
    ).astype(np.float64)
    cpu = total / nshards
    mem = cpu * np.where(mpc != 0, mpc, 1024.0)
    gpu = np.zeros(n, np.float64)
    feat = np.zeros(n, np.uint32)
    fc = snapshot.feature_codes
    for i in gres_rows:
        d = demands[i]
        gpu[i] = float(_gres_gpu_count(d.gres)) * max(1, int(arr[i]))
        feat[i] = _required_features(d, fc)
    pc = snapshot.partition_codes
    part = np.fromiter(
        (pc.get(d.partition, -1) for d in demands), np.int32, n
    )
    return cpu, mem, gpu, part, feat, nshards, prio


def batch_from_scalars(
    scalars: list[tuple[float, float, float, int, int, int, float]],
    *,
    priorities: list[float] | None = None,
) -> JobBatch:
    """Assemble a JobBatch from per-job scalar rows — pure NumPy: gang
    fan-out is one ``np.repeat`` over the shard counts, no per-shard loop."""
    n_jobs = len(scalars)
    cpu = np.fromiter((s[0] for s in scalars), np.float64, n_jobs)
    mem = np.fromiter((s[1] for s in scalars), np.float64, n_jobs)
    gpu = np.fromiter((s[2] for s in scalars), np.float64, n_jobs)
    part = np.fromiter((s[3] for s in scalars), np.int32, n_jobs)
    feat = np.fromiter((s[4] for s in scalars), np.uint32, n_jobs)
    nshards = np.fromiter((s[5] for s in scalars), np.int64, n_jobs)
    if priorities is not None:
        prio = np.asarray(priorities, np.float64)
    else:
        prio = np.fromiter((s[6] for s in scalars), np.float64, n_jobs)
    job_of = np.repeat(np.arange(n_jobs, dtype=np.int32), nshards)
    demand = np.stack([cpu, mem, gpu], axis=1).astype(np.float32)
    return JobBatch(
        demand=demand[job_of].reshape(-1, NUM_RES),
        partition_of=part[job_of],
        req_features=feat[job_of],
        priority=prio.astype(np.float32)[job_of],
        gang_id=job_of.copy(),
        job_of=job_of,
    )


def encode_jobs(
    demands: list[JobDemand],
    snapshot: ClusterSnapshot,
    *,
    priorities: list[float] | None = None,
) -> JobBatch:
    """Lower pending JobDemands into a JobBatch of placement shards.

    Vectorized: per-job scalars once (string parses cached per distinct
    array/gres value), then NumPy repeat for the gang fan-out. Bit-identical
    to :func:`encode_jobs_loop` (the kept-as-oracle reference), pinned by
    the property tests.
    """
    scalars = [job_scalars(d, snapshot) for d in demands]
    return batch_from_scalars(scalars, priorities=priorities)


def encode_jobs_loop(
    demands: list[JobDemand],
    snapshot: ClusterSnapshot,
    *,
    priorities: list[float] | None = None,
) -> JobBatch:
    """The original per-shard loop encoder, kept as the correctness oracle
    for :func:`encode_jobs` (property tests + the bench's loop baseline)."""
    rows_dem: list[tuple[float, float, float]] = []
    rows_part: list[int] = []
    rows_feat: list[int] = []
    rows_prio: list[float] = []
    rows_gang: list[int] = []
    rows_job: list[int] = []
    for j, d in enumerate(demands):
        arr = array_len(d.array)
        total_cpus = float(d.total_cpus(arr))
        nshards = max(1, d.nodes)
        mem_per_cpu = float(d.mem_per_cpu_mb or 1024.0)
        cpu_per_shard = total_cpus / nshards
        # gres is a PER-NODE quantity in Slurm (--gres=gpu:4 means 4 GPUs on
        # every allocated node), so it is NOT divided across shards; the
        # array fan-out multiplies it like the sizecar cpu rule does
        gpu_per_shard = float(_gres_gpu_count(d.gres)) * max(1, arr)
        part = snapshot.partition_codes.get(d.partition, -1)
        feat = _required_features(d, snapshot.feature_codes)
        prio = float(priorities[j]) if priorities is not None else float(d.priority)
        for _ in range(nshards):
            rows_dem.append((cpu_per_shard, cpu_per_shard * mem_per_cpu, gpu_per_shard))
            rows_part.append(part)
            rows_feat.append(feat)
            rows_prio.append(prio)
            rows_gang.append(j)
            rows_job.append(j)
    return JobBatch(
        demand=np.asarray(rows_dem, dtype=np.float32).reshape(-1, NUM_RES),
        partition_of=np.asarray(rows_part, dtype=np.int32),
        req_features=np.asarray(rows_feat, dtype=np.uint32),
        priority=np.asarray(rows_prio, dtype=np.float32),
        gang_id=np.asarray(rows_gang, dtype=np.int32),
        job_of=np.asarray(rows_job, dtype=np.int32),
    )


#: Partition code that matches no node — used for padding rows.
PAD_PARTITION = np.int32(2**30)


def pad_batch(batch: JobBatch, multiple: int) -> JobBatch:
    """Pad a batch to the next multiple of ``multiple`` shards.

    Padded rows can never place (impossible partition code) and never merge
    with real gangs (fresh singleton ids). Under ``jit`` a changing queue
    length means a fresh XLA compile every tick; bucketing the shard axis
    makes the streaming reschedule loop hit a handful of compiled shapes
    (the same trick the sharded path uses for the device grid).
    """
    p = batch.num_shards
    target = max(multiple, ((p + multiple - 1) // multiple) * multiple)
    if target == p:
        return batch
    pad = target - p
    gang_base = int(batch.gang_id.max()) + 1 if p else 0
    return JobBatch(
        demand=np.concatenate([batch.demand, np.zeros((pad, NUM_RES), np.float32)]),
        partition_of=np.concatenate(
            [batch.partition_of, np.full(pad, PAD_PARTITION, np.int32)]
        ),
        req_features=np.concatenate([batch.req_features, np.zeros(pad, np.uint32)]),
        priority=np.concatenate(
            [batch.priority, np.full(pad, -1e30, np.float32)]
        ),
        gang_id=np.concatenate(
            [batch.gang_id, gang_base + np.arange(pad, dtype=np.int32)]
        ),
        job_of=np.concatenate([batch.job_of, np.full(pad, -1, np.int32)]),
    )


def random_inventory(
    num_nodes: int,
    num_jobs: int,
    *,
    seed: int = 0,
    num_partitions: int = 4,
    gpu_fraction: float = 0.15,
    gang_fraction: float = 0.05,
    gang_size: int = 4,
    load: float = 0.7,
    drain_fraction: float = 0.01,
) -> tuple[list[PartitionInfo], list[NodeInfo], list[JobDemand]]:
    """Synthetic inventory at the TYPED level (NodeInfo/PartitionInfo/
    JobDemand) — the raw form the agent RPCs deliver, for benchmarking the
    full tick pipeline (proto decode → encode → solve) rather than just the
    solve. ``random_scenario`` remains the already-encoded twin for
    solver-only benchmarks; distributions match.
    """
    rng = np.random.default_rng(seed)
    cpus = rng.choice([32, 64, 128], size=num_nodes)
    mem = cpus * rng.choice([2048, 4096], size=num_nodes)
    has_gpu = rng.random(num_nodes) < gpu_fraction
    gpus = np.where(has_gpu, rng.choice([4, 8], size=num_nodes), 0)
    part = rng.integers(0, num_partitions, size=num_nodes)
    used_frac = rng.uniform(0.0, 0.3, size=num_nodes)
    alloc_cpus = np.floor(cpus * used_frac).astype(np.int64)
    alloc_mem = np.floor(mem * used_frac).astype(np.int64)
    drained = rng.random(num_nodes) < drain_fraction
    nodes = [
        NodeInfo(
            name=f"node{i:05d}",
            cpus=int(cpus[i]),
            alloc_cpus=int(alloc_cpus[i]),
            memory_mb=int(mem[i]),
            alloc_memory_mb=int(alloc_mem[i]),
            gpus=int(gpus[i]),
            gpu_type="gpu_type0" if has_gpu[i] else "",
            features=("gpu_type0",) if has_gpu[i] else (),
            state="DRAINED" if drained[i] else ("MIXED" if used_frac[i] > 0 else "IDLE"),
        )
        for i in range(num_nodes)
    ]
    members: list[list[str]] = [[] for _ in range(num_partitions)]
    for i in range(num_nodes):
        members[int(part[i])].append(nodes[i].name)
    partitions = [
        PartitionInfo(name=f"part{k}", nodes=tuple(members[k]))
        for k in range(num_partitions)
    ]

    mean_cpu_free = float(np.maximum(cpus - alloc_cpus, 0).mean())
    lam = max(1.0, load * mean_cpu_free * num_nodes / max(1, num_jobs))
    jcpu = np.maximum(1, rng.poisson(lam, size=num_jobs))
    jmem = rng.choice([1024, 2048, 4096], size=num_jobs)
    is_gpu_job = rng.random(num_jobs) < gpu_fraction
    jgpu = rng.integers(1, 5, size=num_jobs)
    jpart = rng.integers(0, num_partitions, size=num_jobs)
    prio = rng.integers(0, 100, size=num_jobs)
    is_gang = rng.random(num_jobs) < gang_fraction
    demands = [
        JobDemand(
            partition=f"part{int(jpart[j])}",
            job_name=f"job{j}",
            cpus_per_task=int(jcpu[j]),
            ntasks=1,
            nodes=gang_size if is_gang[j] else 1,
            mem_per_cpu_mb=int(jmem[j]),
            gres=f"gpu:gpu_type0:{int(jgpu[j])}" if is_gpu_job[j] else "",
            priority=int(prio[j]),
        )
        for j in range(num_jobs)
    ]
    return partitions, nodes, demands


def random_scenario(
    num_nodes: int,
    num_jobs: int,
    *,
    seed: int = 0,
    num_partitions: int = 4,
    gpu_fraction: float = 0.0,
    gang_fraction: float = 0.0,
    gang_size: int = 4,
    load: float = 0.7,
) -> tuple[ClusterSnapshot, JobBatch]:
    """Synthetic benchmark scenario generator (BASELINE.md configs #2-#5).

    ``load`` scales total job demand relative to total cluster capacity.
    """
    rng = np.random.default_rng(seed)
    cpus = rng.choice([32, 64, 128], size=num_nodes).astype(np.float32)
    mem = cpus * rng.choice([2048, 4096], size=num_nodes).astype(np.float32)
    has_gpu = rng.random(num_nodes) < gpu_fraction
    gpus = np.where(has_gpu, rng.choice([4, 8], size=num_nodes), 0).astype(np.float32)
    part = rng.integers(0, num_partitions, size=num_nodes).astype(np.int32)
    features = np.where(has_gpu, np.uint32(1), np.uint32(0))

    capacity = np.stack([cpus, mem, gpus], axis=1)
    # start with some pre-existing allocation
    used_frac = rng.uniform(0.0, 0.3, size=(num_nodes, 1)).astype(np.float32)
    free = np.round(capacity * (1.0 - used_frac))

    snapshot = ClusterSnapshot(
        node_names=[f"node{i:05d}" for i in range(num_nodes)],
        capacity=capacity,
        free=free.astype(np.float32),
        partition_of=part,
        features=features,
        partition_codes={f"part{i}": i for i in range(num_partitions)},
        feature_codes={"gpu_type0": 0},
    )

    # jobs: scale mean demand so total ≈ load × total free capacity
    mean_cpu_free = float(free[:, 0].mean())
    lam = max(1.0, load * mean_cpu_free * num_nodes / max(1, num_jobs))
    jcpu = np.maximum(1, rng.poisson(lam, size=num_jobs)).astype(np.float32)
    jmem = jcpu * rng.choice([1024, 2048, 4096], size=num_jobs).astype(np.float32)
    is_gpu_job = rng.random(num_jobs) < gpu_fraction
    jgpu = np.where(is_gpu_job, rng.integers(1, 5, size=num_jobs), 0).astype(np.float32)
    jpart = rng.integers(0, num_partitions, size=num_jobs).astype(np.int32)
    jfeat = np.where(is_gpu_job, np.uint32(1), np.uint32(0))
    prio = rng.uniform(0, 100, size=num_jobs).astype(np.float32)

    is_gang = rng.random(num_jobs) < gang_fraction
    rows = []
    for j in range(num_jobs):
        n = gang_size if is_gang[j] else 1
        for _ in range(n):
            rows.append(j)
    job_of = np.asarray(rows, dtype=np.int32)
    batch = JobBatch(
        demand=np.stack(
            [jcpu[job_of] / np.where(is_gang[job_of], gang_size, 1),
             jmem[job_of] / np.where(is_gang[job_of], gang_size, 1),
             jgpu[job_of]],
            axis=1,
        ).astype(np.float32),
        partition_of=jpart[job_of],
        req_features=jfeat[job_of],
        priority=prio[job_of],
        gang_id=job_of.copy(),
        job_of=job_of,
    )
    return snapshot, batch
