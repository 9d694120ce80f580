"""The benchmark's frozen copy of the simulator's cluster and trace draws.

The harness under test builds its cluster and its job trace from the seed
itself. This module makes the same two things from the same seed for the
plain reference, with plain NumPy and no import of the program, so the
reference never reads the program's copy: the program's cluster and trace
are outputs that the judge compares with these.

Draw order and arithmetic follow the simulator's generator as it stood when
the benchmark was written (node capacities, partitions, a GPU island, a
pre-existing allocation; per-job partition, cpus, memory, GPUs, gang size,
priority, duration and class). Only the front-loaded and the Poisson arrival
processes are copied: the benchmark's traffic files use no other.

A traffic file lists one or more populations; each is drawn in turn from
the same generator and numbered on from the last, so one tick's arrivals
stay in name order. The trace made here is the one both sides run: the
harness under test is handed it (``scenario.arrivals``) and the reference
follows it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

GPU_FEATURE = "gpu_type0"
CLASS_LABEL = "sbt.kubecluster.org/priority-class"


@dataclass
class Cluster:
    names: list[str]
    cpus: np.ndarray  # [N] int
    mem: np.ndarray  # [N] int (MB)
    gpus: np.ndarray  # [N] int
    part: np.ndarray  # [N] int partition index
    base_cpus: np.ndarray  # [N] int pre-existing allocation
    base_mem: np.ndarray  # [N] int
    #: partition name -> member node names, in the agent's listing order
    partitions: dict[str, tuple[str, ...]]

    @property
    def features(self) -> list[tuple[str, ...]]:
        return [(GPU_FEATURE,) if g else () for g in self.gpus.tolist()]


@dataclass
class Job:
    tick: int
    name: str
    partition: str
    cpus_per_task: int
    nodes: int  # 1, or the gang size
    mem_per_cpu_mb: int
    gpus: int  # per node; 0 = no gres
    priority: int
    duration_s: float
    job_class: str  # "" = unlabeled

    @property
    def gres(self) -> str:
        return f"gpu:{GPU_FEATURE}:{self.gpus}" if self.gpus else ""


def build_cluster(c: dict, rng: np.random.Generator) -> Cluster:
    """Nodes and partitions of one configuration (its ``cluster`` block)."""
    n = int(c["num_nodes"])
    nparts = int(c.get("num_partitions", 4))
    cpus = rng.choice(tuple(c.get("cpu_choices", (32, 64, 128))), size=n)
    mem = cpus * rng.choice(tuple(c.get("mem_per_cpu_choices", (2048, 4096))), size=n)
    has_gpu = rng.random(n) < float(c.get("gpu_fraction", 0.15))
    gpus = np.where(has_gpu, rng.choice(tuple(c.get("gpu_choices", (4, 8))), size=n), 0)
    part = rng.integers(0, nparts, size=n)
    base = rng.uniform(0.0, 2.0 * float(c.get("base_load", 0.15)), size=n)
    names = [f"node{i:05d}" for i in range(n)]
    members: dict[str, list[str]] = {f"part{k}": [] for k in range(nparts)}
    for i in range(n):
        members[f"part{int(part[i])}"].append(names[i])
    return Cluster(
        names=names,
        cpus=cpus.astype(np.int64),
        mem=mem.astype(np.int64),
        gpus=gpus.astype(np.int64),
        part=part.astype(np.int64),
        base_cpus=(cpus * base).astype(np.int64),
        base_mem=(mem * base).astype(np.int64),
        partitions={k: tuple(v) for k, v in members.items()},
    )


def arrival_ticks(arrival: str, jobs: int, ticks: int, rng: np.random.Generator) -> np.ndarray:
    """Each job's arrival tick: ``front`` puts every job at tick 0;
    ``poisson`` draws Poisson(jobs / ticks) arrivals in each of ``ticks``
    ticks, capped at ``jobs`` in all."""
    if arrival == "front":
        return np.zeros(jobs, dtype=np.int64)
    if arrival != "poisson":
        raise ValueError(f"unknown arrival process {arrival!r}")
    window = max(1, ticks)
    counts = rng.poisson(jobs / window, size=window)
    return np.repeat(np.arange(window, dtype=np.int64), counts)[:jobs]


def generate_trace(w: dict, cl: Cluster, ticks: int, rng: np.random.Generator,
                   first: int = 0) -> list[list[Job]]:
    """Per-tick arrivals of one workload block (``arrival``, ``jobs``,
    ``gang_fraction``, ``gang_size``, ``gpu_fraction``, ``cpu_choices``,
    ``mem_per_cpu_choices``, ``duration_range``, ``priority_range``,
    ``priority_classes``) over ``ticks`` ticks, numbered from ``first``."""
    nparts = len(cl.partitions)
    gang_size = int(w.get("gang_size", 4))
    arrive = arrival_ticks(w.get("arrival", "poisson"), int(w["jobs"]), ticks, rng)
    n = len(arrive)
    cpu = rng.choice(tuple(w.get("cpu_choices", (1, 2, 4, 8))), size=n)
    mem = rng.choice(tuple(w.get("mem_per_cpu_choices", (1024, 2048, 4096))), size=n)
    is_gpu = rng.random(n) < float(w.get("gpu_fraction", 0.1))
    ngpu = rng.integers(1, 5, size=n)
    is_gang = rng.random(n) < float(w.get("gang_fraction", 0.05))
    part = rng.integers(0, nparts, size=n)
    lo, hi = w.get("priority_range", (0, 100))
    prio = rng.integers(lo, hi + 1, size=n)
    dur = rng.uniform(*w.get("duration_range", (5.0, 60.0)), size=n)
    classes = w.get("priority_classes", ())
    cls_pick = rng.random(n) if classes else None
    if classes:
        cls_names = [c for c, _w in classes]
        wt = np.asarray([x for _c, x in classes], np.float64)
        cls_cum = np.cumsum(wt / max(wt.sum(), 1e-9))
    sizes = [len(cl.partitions[f"part{k}"]) for k in range(nparts)]
    gpu_caps = [
        max((int(cl.gpus[int(nm[4:])]) for nm in cl.partitions[f"part{k}"]), default=0)
        for k in range(nparts)
    ]
    gpu_counts = [
        sum(1 for nm in cl.partitions[f"part{k}"] if cl.gpus[int(nm[4:])] > 0)
        for k in range(nparts)
    ]
    pop_parts = [k for k, sz in enumerate(sizes) if sz > 0]
    gpu_parts = [k for k, cap in enumerate(gpu_caps) if cap > 0]
    gang_parts = [k for k, sz in enumerate(sizes) if sz >= gang_size]
    out: list[list[Job]] = [[] for _ in range(ticks)]
    for j in range(n):
        k = int(part[j])
        gpu_j = bool(is_gpu[j]) and bool(gpu_parts)
        gang_j = bool(is_gang[j]) and bool(gang_parts)
        if gpu_j and gang_j:
            both = [p for p in gpu_parts if p in gang_parts and gpu_counts[p] >= gang_size]
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
        count = min(int(ngpu[j]), gpu_caps[k]) if gpu_j else 0
        job_class = ""
        if cls_pick is not None:
            pick = int(np.searchsorted(cls_cum, cls_pick[j], side="right"))
            job_class = cls_names[min(max(pick, 0), len(cls_names) - 1)]
        tick = int(arrive[j])
        out[tick].append(Job(
            tick=tick,
            name=f"sim-{first + j:06d}",
            partition=f"part{k}",
            cpus_per_task=int(cpu[j]),
            nodes=gang_size if gang_j else 1,
            mem_per_cpu_mb=int(mem[j]),
            gpus=count,
            priority=int(prio[j]),
            duration_s=float(np.round(dur[j], 3)),
            job_class=job_class,
        ))
    return out


def make(config: dict, traffic: dict, ticks: int, seed: int) -> tuple[Cluster, list[list[Job]]]:
    """The cluster and trace of one run: the configuration's cluster and
    job shapes, each of the traffic's populations (its arrival process,
    the scale key it counts by, its overrides) in turn, ``ticks`` ticks,
    all from ``seed``."""
    rng = np.random.default_rng(seed)
    cl = build_cluster(config["cluster"], rng)
    trace: list[list[Job]] = [[] for _ in range(ticks)]
    first = 0
    for w in workloads(config, traffic, ticks):
        for t, arrivals in enumerate(generate_trace(w, cl, ticks, rng, first)):
            trace[t] += arrivals
        first = sum(len(a) for a in trace)
    return cl, trace


def workloads(config: dict, traffic: dict, ticks: int) -> list[dict]:
    """The workload blocks a run draws its trace from, one a population:
    ``front`` takes ``count`` jobs at tick 0, ``poisson`` ``count`` a tick
    on average; ``count`` names a key of the configuration's ``scale``."""
    out = []
    for pop in traffic["populations"]:
        w = dict(config.get("jobs", {}))
        w.update(pop.get("jobs", {}))
        w["arrival"] = pop["arrival"]
        n = int(config["scale"][pop["count"]])
        w["jobs"] = n * ticks if pop["arrival"] == "poisson" else n
        out.append(w)
    return out
