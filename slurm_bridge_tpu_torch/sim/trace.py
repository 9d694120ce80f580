"""Synthetic cluster + workload trace generation (seeded, deterministic).

Distributions intentionally match ``solver/snapshot.py::random_inventory``
(the already-typed benchmark generator) so simulator scenarios and the
solver-only benchmarks describe the same population: node cpus from
{32, 64, 128}, mem 2–4 GiB/cpu, a GPU island, a small pre-existing
allocation, and jobs whose mean demand scales with cluster free capacity.
On top of that, this module adds what a *trace* needs and a static batch
doesn't: arrival processes (Poisson rate, front-loaded backlog, bursts),
per-job virtual durations, and heterogeneous partition/feature layout.

Everything derives from one ``numpy`` Generator the caller seeds; no
wall-clock, no global state.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from slurm_bridge_tpu_torch.bridge.objects import BridgeJobSpec
from slurm_bridge_tpu_torch.policy.classes import CLASS_LABEL, TENANT_LABEL
from slurm_bridge_tpu_torch.sim.agent import SimNode

GPU_FEATURE = "gpu_type0"


@dataclass(frozen=True)
class ClusterSpec:
    """Shape of the synthetic cluster."""

    num_nodes: int
    num_partitions: int = 4
    cpu_choices: tuple[int, ...] = (32, 64, 128)
    mem_per_cpu_choices: tuple[int, ...] = (2048, 4096)
    gpu_fraction: float = 0.15
    gpu_choices: tuple[int, ...] = (4, 8)
    #: extra per-partition feature tags (partition k gets feature
    #: ``tier{k % len}``) — exercises the heterogeneous-features path
    partition_features: tuple[str, ...] = ()
    #: mean pre-existing (non-sim) allocation fraction, uniform [0, 2×mean]
    base_load: float = 0.15


@dataclass(frozen=True)
class WorkloadSpec:
    """Arrival process + per-job demand distributions.

    ``arrival``:
    - ``"front"``  — every job arrives at tick 0 (cold-start backlog);
    - ``"poisson"``— Poisson(jobs/spread_ticks) arrivals per tick over the
      first ``spread_ticks`` ticks;
    - ``"burst"``  — jobs split evenly across ``burst_ticks``;
    - ``"diurnal"``— Poisson with a sinusoidal day/night rate over the
      first ``spread_ticks`` ticks (``diurnal_cycles`` peaks).

    Tenancy/class fields are OFF by default and — deliberately — draw
    NOTHING from the RNG when off, so every pre-existing scenario's
    random stream (and therefore its determinism digest) is untouched:

    - ``tenants`` > 0 labels each job ``tenant-<k>`` (uniform draw);
    - ``tenant_priorities`` (len == tenants) maps each tenant's jobs
      into its own priority range via a deterministic transform of the
      already-drawn priority (no extra draws) — the skew the
      multi-tenant fairness scenario runs on;
    - ``priority_classes`` assigns a class label by weighted draw.
    """

    jobs: int
    arrival: str = "poisson"
    spread_ticks: int = 10
    burst_ticks: tuple[int, ...] = (0,)
    gang_fraction: float = 0.05
    gang_size: int = 4
    gpu_fraction: float = 0.1
    cpu_choices: tuple[int, ...] = (1, 2, 4, 8)
    mem_per_cpu_choices: tuple[int, ...] = (1024, 2048, 4096)
    #: virtual-seconds runtime, uniform over [lo, hi)
    duration_range: tuple[float, float] = (5.0, 60.0)
    priority_range: tuple[int, int] = (0, 100)
    #: sinusoid peaks across the spread window (arrival="diurnal")
    diurnal_cycles: int = 2
    #: tenants for fair-share scenarios; 0 = unlabeled (no RNG drawn)
    tenants: int = 0
    #: per-tenant (lo, hi) priority ranges (len == tenants)
    tenant_priorities: tuple[tuple[int, int], ...] = ()
    #: (class name, weight) distribution for priority-class labels
    priority_classes: tuple[tuple[str, float], ...] = ()


@dataclass
class JobArrival:
    """One trace entry: a BridgeJob spec arriving at ``tick``."""

    tick: int
    name: str
    spec: BridgeJobSpec
    duration_s: float
    #: CR metadata labels (tenant / priority-class); empty = unlabeled
    labels: dict = field(default_factory=dict)


def build_cluster(
    spec: ClusterSpec, rng: np.random.Generator
) -> tuple[list[SimNode], dict[str, tuple[str, ...]]]:
    """Nodes + partition membership for one scenario."""
    n = spec.num_nodes
    cpus = rng.choice(spec.cpu_choices, size=n)
    mem = cpus * rng.choice(spec.mem_per_cpu_choices, size=n)
    has_gpu = rng.random(n) < spec.gpu_fraction
    gpus = np.where(has_gpu, rng.choice(spec.gpu_choices, size=n), 0)
    part = rng.integers(0, spec.num_partitions, size=n)
    base = rng.uniform(0.0, 2.0 * spec.base_load, size=n)
    nodes: list[SimNode] = []
    members: dict[str, list[str]] = {
        f"part{k}": [] for k in range(spec.num_partitions)
    }
    for i in range(n):
        feats: tuple[str, ...] = (GPU_FEATURE,) if has_gpu[i] else ()
        if spec.partition_features:
            tag = spec.partition_features[
                int(part[i]) % len(spec.partition_features)
            ]
            feats = feats + (tag,)
        name = f"node{i:05d}"
        nodes.append(
            SimNode(
                name=name,
                cpus=int(cpus[i]),
                memory_mb=int(mem[i]),
                gpus=int(gpus[i]),
                gpu_type=GPU_FEATURE if has_gpu[i] else "",
                features=feats,
                base_alloc_cpus=int(cpus[i] * base[i]),
                base_alloc_memory_mb=int(mem[i] * base[i]),
            )
        )
        members[f"part{int(part[i])}"].append(name)
    partitions = {k: tuple(v) for k, v in members.items()}
    return nodes, partitions


def _arrival_ticks(
    spec: WorkloadSpec, ticks: int, rng: np.random.Generator
) -> np.ndarray:
    if spec.arrival == "front":
        return np.zeros(spec.jobs, dtype=np.int64)
    if spec.arrival == "burst":
        burst = np.asarray(spec.burst_ticks, dtype=np.int64)
        return burst[np.arange(spec.jobs) % len(burst)]
    if spec.arrival == "poisson":
        window = max(1, min(spec.spread_ticks, ticks))
        rate = spec.jobs / window
        counts = rng.poisson(rate, size=window)
        out = np.repeat(np.arange(window, dtype=np.int64), counts)
        return out[: spec.jobs]  # cap at the nominal total
    if spec.arrival == "diurnal":
        # sinusoidal day/night load: per-tick Poisson rate ∝ 1 + sin,
        # normalized so the window's expected total is ``jobs``
        window = max(1, min(spec.spread_ticks, ticks))
        t = np.arange(window, dtype=np.float64)
        wave = 1.0 + np.sin(2.0 * np.pi * spec.diurnal_cycles * t / window)
        rates = spec.jobs * wave / max(wave.sum(), 1e-9)
        counts = rng.poisson(rates)
        out = np.repeat(np.arange(window, dtype=np.int64), counts)
        return out[: spec.jobs]
    raise ValueError(f"unknown arrival process {spec.arrival!r}")


def generate_trace(
    spec: WorkloadSpec,
    cluster: ClusterSpec,
    ticks: int,
    rng: np.random.Generator,
    *,
    name_prefix: str = "sim",
    partition_sizes: list[int] | None = None,
    partition_gpu_caps: list[int] | None = None,
    partition_gpu_counts: list[int] | None = None,
) -> list[list[JobArrival]]:
    """Per-tick arrival lists (index = tick; length = ``ticks``).

    ``partition_sizes``/``partition_gpu_caps`` (from the BUILT cluster)
    keep the trace feasible by construction: GPU jobs only target
    partitions that actually have GPU nodes (capped at the partition's
    max per-node GPU count) and gangs only target partitions with at
    least ``gang_size`` members — a job that could never place anywhere
    would make "eventual drain" unfalsifiable, not robust.
    """
    arrive = _arrival_ticks(spec, ticks, rng)
    n = len(arrive)
    cpu = rng.choice(spec.cpu_choices, size=n)
    mem = rng.choice(spec.mem_per_cpu_choices, size=n)
    is_gpu = rng.random(n) < spec.gpu_fraction
    ngpu = rng.integers(1, 5, size=n)
    is_gang = rng.random(n) < spec.gang_fraction
    part = rng.integers(0, cluster.num_partitions, size=n)
    prio = rng.integers(spec.priority_range[0], spec.priority_range[1] + 1, size=n)
    dur = rng.uniform(*spec.duration_range, size=n)
    # tenancy/class draws happen ONLY when enabled — and strictly after
    # every pre-existing draw — so scenarios without them replay the
    # exact PR-8 random stream (digest byte-compat is gated on this)
    tenant_idx = (
        rng.integers(0, spec.tenants, size=n) if spec.tenants > 0 else None
    )
    cls_pick = rng.random(n) if spec.priority_classes else None
    if spec.priority_classes:
        cls_names = [c for c, _w in spec.priority_classes]
        w = np.asarray([w for _c, w in spec.priority_classes], np.float64)
        cls_cum = np.cumsum(w / max(w.sum(), 1e-9))
    # feasible target sets (see docstring): populated partitions for any
    # job — random node assignment can leave a partition EMPTY at small
    # node counts, and a job aimed there could never place — GPU-bearing
    # ones for GPU jobs, big-enough ones for gangs
    pop_parts = (
        [k for k, sz in enumerate(partition_sizes) if sz > 0]
        if partition_sizes is not None
        else list(range(cluster.num_partitions))
    )
    gpu_parts = (
        [k for k, cap in enumerate(partition_gpu_caps) if cap > 0]
        if partition_gpu_caps is not None
        else list(range(cluster.num_partitions))
    )
    gang_parts = (
        [k for k, sz in enumerate(partition_sizes) if sz >= spec.gang_size]
        if partition_sizes is not None
        else list(range(cluster.num_partitions))
    )
    out: list[list[JobArrival]] = [[] for _ in range(ticks)]
    for j in range(n):
        tick = int(arrive[j])
        if tick >= ticks:
            continue
        k = int(part[j])
        gpu_j = bool(is_gpu[j]) and bool(gpu_parts)
        gang_j = bool(is_gang[j]) and bool(gang_parts)
        if gpu_j and gang_j:
            # a GPU gang needs gang_size DISTINCT GPU nodes in one
            # partition — an all-or-nothing request no partition can ever
            # satisfy would wedge the drain check, so fall back to a
            # single-node GPU job when the cluster can't host the gang
            both = [
                p
                for p in gpu_parts
                if p in gang_parts
                and (
                    partition_gpu_counts is None
                    or partition_gpu_counts[p] >= spec.gang_size
                )
            ]
            if both:
                k = both[k % len(both)]
            else:
                gang_j = False
                k = gpu_parts[k % len(gpu_parts)]
        elif gpu_j:
            k = gpu_parts[k % len(gpu_parts)]
        elif gang_j:
            k = gang_parts[k % len(gang_parts)]
        elif pop_parts:
            k = pop_parts[k % len(pop_parts)]
        count = int(ngpu[j])
        if gpu_j and partition_gpu_caps is not None:
            count = min(count, partition_gpu_caps[k])
        prio_j = int(prio[j])
        labels: dict[str, str] = {}
        if tenant_idx is not None:
            t = int(tenant_idx[j])
            labels[TENANT_LABEL] = f"tenant-{t}"
            if spec.tenant_priorities:
                # per-tenant priority skew as a deterministic transform
                # of the already-drawn priority (no extra RNG)
                lo, hi = spec.tenant_priorities[t % len(spec.tenant_priorities)]
                prio_j = int(lo) + prio_j % (int(hi) - int(lo) + 1)
        if cls_pick is not None:
            labels[CLASS_LABEL] = cls_names[
                int(np.searchsorted(cls_cum, cls_pick[j], side="right").clip(
                    0, len(cls_names) - 1
                ))
            ]
        spec_j = BridgeJobSpec(
            partition=f"part{k}",
            sbatch_script="#!/bin/sh\n: sim workload\n",
            cpus_per_task=int(cpu[j]),
            ntasks=1,
            nodes=spec.gang_size if gang_j else 1,
            mem_per_cpu_mb=int(mem[j]),
            gres=f"gpu:{GPU_FEATURE}:{count}" if gpu_j else "",
            priority=prio_j,
        )
        out[tick].append(
            JobArrival(
                tick=tick,
                name=f"{name_prefix}-{j:06d}",
                spec=spec_j,
                duration_s=float(np.round(dur[j], 3)),
                labels=labels,
            )
        )
    return out


def storm_arrivals(
    tick: int,
    count: int,
    cluster: ClusterSpec,
    rng: np.random.Generator,
    *,
    priority: int = 1000,
    name_prefix: str = "storm",
    gang_size: int = 1,
    storm_class: str = "",
    eligible_parts: list[int] | None = None,
    cpus: tuple[int, ...] = (4, 8, 16),
) -> list[JobArrival]:
    """High-priority burst for a ``preemption_storm`` fault window.

    ``gang_size`` > 1 makes each storm job an all-or-nothing gang (the
    ``priority_inversion`` scenario's production gang), restricted to
    ``eligible_parts`` (partitions big enough to host it — the harness
    computes these from the BUILT cluster); ``storm_class`` stamps a
    priority-class label. Defaults reproduce the PR-2 storm exactly —
    same draws, same specs."""
    cpu = rng.choice(cpus, size=count)
    part = rng.integers(0, cluster.num_partitions, size=count)
    dur = rng.uniform(10.0, 30.0, size=count)
    labels = {CLASS_LABEL: storm_class} if storm_class else {}
    parts_of = list(eligible_parts) if eligible_parts else None
    return [
        JobArrival(
            tick=tick,
            name=f"{name_prefix}-{tick}-{j:05d}",
            spec=BridgeJobSpec(
                partition=(
                    f"part{parts_of[int(part[j]) % len(parts_of)]}"
                    if parts_of
                    else f"part{int(part[j])}"
                ),
                sbatch_script="#!/bin/sh\n: storm\n",
                cpus_per_task=int(cpu[j]),
                ntasks=1,
                nodes=gang_size if gang_size > 1 else 0,
                mem_per_cpu_mb=1024,
                priority=priority,
            ),
            duration_s=float(np.round(dur[j], 3)),
            labels=dict(labels),
        )
        for j in range(count)
    ]
