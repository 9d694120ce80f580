"""A cell's files lowered onto the program's simulator ``Scenario``, and
the benchmark's trace handed to it.

This is the only module of the benchmark that names the program's
configuration types; the reference never imports it.
"""

from __future__ import annotations

from bblib import gen


def build(config: dict, ticks: int, seed: int, *, dtype: str | None = None):
    """The ``Scenario`` one run drives: ``ticks`` ticks on the
    configuration's cluster and bridge, from ``seed``. Its own workload is
    empty: the run's trace is the benchmark's (:func:`arrivals`).
    ``dtype`` replaces the configuration's scoring precision (the
    control)."""
    from slurm_bridge_tpu_torch.admission import AdmissionConfig
    from slurm_bridge_tpu_torch.policy.engine import PolicyConfig
    from slurm_bridge_tpu_torch.sim.harness import Scenario
    from slurm_bridge_tpu_torch.sim.trace import ClusterSpec, WorkloadSpec
    from slurm_bridge_tpu_torch.solver.auction import AuctionConfig

    c = config["cluster"]
    b = config["bridge"]
    auction = dict(b["auction"])
    if dtype is not None:
        auction["dtype"] = dtype
    return Scenario(
        name=config["name"],
        cluster=ClusterSpec(
            num_nodes=int(c["num_nodes"]),
            num_partitions=int(c["num_partitions"]),
            cpu_choices=tuple(c["cpu_choices"]),
            mem_per_cpu_choices=tuple(c["mem_per_cpu_choices"]),
            gpu_fraction=float(c["gpu_fraction"]),
            gpu_choices=tuple(c["gpu_choices"]),
            base_load=float(c["base_load"]),
        ),
        workload=WorkloadSpec(jobs=0, arrival="front"),
        ticks=ticks,
        tick_interval_s=float(b["tick_interval_s"]),
        seed=seed,
        backend=b["backend"],
        auction_config=AuctionConfig(**auction),
        policy=PolicyConfig() if b["policy"] else None,
        admission=AdmissionConfig() if b["admission"] else None,
        preemption=bool(b["preemption"]),
        incremental=bool(b["incremental"]),
        persistence=bool(b["persistence"]),
        expect_drain=False,
        drain_grace_ticks=0,
    )


def arrivals(trace: list[list[gen.Job]]) -> list:
    """The benchmark's trace as the harness's per-tick arrival lists."""
    from slurm_bridge_tpu_torch.bridge.objects import BridgeJobSpec
    from slurm_bridge_tpu_torch.sim.trace import JobArrival

    script = "#!/bin/sh\n: sim workload\n"
    return [[JobArrival(
        tick=j.tick,
        name=j.name,
        spec=BridgeJobSpec(partition=j.partition, sbatch_script=script,
                           cpus_per_task=j.cpus_per_task, ntasks=1, nodes=j.nodes,
                           mem_per_cpu_mb=j.mem_per_cpu_mb, gres=j.gres, priority=j.priority),
        duration_s=j.duration_s,
        labels={gen.CLASS_LABEL: j.job_class} if j.job_class else {},
    ) for j in tick] for tick in trace]
