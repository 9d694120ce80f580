"""sim/ — deterministic cluster simulator + fault-injection harness.

The round-5 VERDICT's biggest open gap: the north-star metric (full
reconcile-tick latency through store → scheduler → mirror) had only ever
been driven at 2k pods × 1k nodes, and every robustness claim rested on
hand-written unit fixtures. This package closes both: a seeded
discrete-event simulator that

- generates synthetic clusters and workload traces (Poisson/burst
  arrivals, gang jobs, heterogeneous partitions/features, node
  drain/resume churn) at up to 50k pods × 10k nodes (``trace``);
- drives the REAL bridge pipeline — :class:`ObjectStore`,
  :class:`BridgeOperator`, :class:`PlacementScheduler.tick`, the
  virtual-node mirror and statusmap — against an in-process fake agent
  with no wall-clock sleeps, advancing virtual time (``harness``,
  ``agent``);
- injects faults through a composable :class:`FaultPlan` (agent RPC
  errors/latency, stale snapshots, lost status updates, preemption
  storms, partition disappearance) and asserts invariants after every
  tick: no double-bind, gang atomicity, capacity never oversubscribed,
  eventual drain of the pending queue (``faults``, ``invariants``);
- emits per-scenario JSON metrics: tick p50/p95 broken into
  store/encode/solve/bind/mirror phases, placement quality, preemption
  count, recovery time after fault clear (``harness.ScenarioResult``).

Same seed ⇒ byte-identical deterministic section of the metrics JSON
(timing lives in a separate, explicitly non-deterministic section).

Entry points: ``python -m slurm_bridge_tpu_torch.sim`` (``cli``), the named
scenario files under ``benchmarks/scenarios/sim_*.py``, and
``make sim-smoke``.
"""

from slurm_bridge_tpu_torch.sim.agent import SimCluster, SimWorkloadClient
from slurm_bridge_tpu_torch.sim.faults import Fault, FaultPlan, SimRpcError
from slurm_bridge_tpu_torch.sim.harness import Scenario, ScenarioResult, run_scenario
from slurm_bridge_tpu_torch.sim.trace import ClusterSpec, WorkloadSpec

__all__ = [
    "ClusterSpec",
    "Fault",
    "FaultPlan",
    "Scenario",
    "ScenarioResult",
    "SimCluster",
    "SimRpcError",
    "SimWorkloadClient",
    "WorkloadSpec",
    "run_scenario",
]
