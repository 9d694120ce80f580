"""Invariant checks run after every simulated tick.

Four families (ISSUE 2 acceptance):

- **no double-bind** — a sizecar pod is bound to at most one virtual
  node, carries hints iff bound, and no Slurm job id is owned by two
  pods;
- **gang atomicity** — a bound ``nodes=k`` job holds exactly ``k``
  distinct placement hints (all-or-nothing admission);
- **capacity never oversubscribed** — ground truth first (the
  :class:`SimCluster` raises on any allocation past capacity; re-checked
  here), plus a solver-level check that the demand newly bound this tick
  fits the free capacity the scheduler solved against (skipped inside a
  ``stale_snapshot`` window, where binding past *current* truth is the
  expected, queue-absorbed behaviour — the sim agent queues what no
  longer fits, so ground truth still holds);
- **eventual drain** — scenario-end check (harness): once arrivals stop
  and faults clear, the pending queue empties within the drain grace.

Violations are collected, not raised: a scenario reports every breach in
its deterministic metrics section and the smoke gate fails on any.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from slurm_bridge_tpu_torch.bridge.objects import Pod, PodRole
from slurm_bridge_tpu_torch.core.arrays import array_len
from slurm_bridge_tpu_torch.core.scontrol import parse_gres_gpus
from slurm_bridge_tpu_torch.core.types import JobDemand
from slurm_bridge_tpu_torch.obs.metrics import REGISTRY
from slurm_bridge_tpu_torch.sim.agent import SimCluster

_violations_total = REGISTRY.counter(
    "sbt_sim_invariant_violations_total",
    "simulator invariant breaches detected after a tick",
)


@dataclass(frozen=True)
class Violation:
    tick: int
    invariant: str
    detail: str

    def as_dict(self) -> dict:
        return {"tick": self.tick, "invariant": self.invariant, "detail": self.detail}


def per_node_demand(demand: JobDemand) -> tuple[float, float, float]:
    """(cpus, mem_mb, gpus) per placement shard — the encode_jobs sizing
    rule (solver/snapshot.py), gres being a per-node quantity."""
    arr = array_len(demand.array) if demand.array else 1
    nshards = max(1, demand.nodes)
    cpu = demand.total_cpus(arr) / nshards
    mem = cpu * float(demand.mem_per_cpu_mb or 1024.0)
    gpus = float(parse_gres_gpus(demand.gres)[0] if demand.gres else 0) * max(1, arr)
    return cpu, mem, gpus


def _sizecars(pods: list[Pod]) -> list[Pod]:
    return [p for p in pods if p.spec.role == PodRole.SIZECAR and not p.meta.deleted]


def check_tick(
    tick: int,
    pods: list[Pod],
    cluster: SimCluster,
    *,
    newly_bound: list[Pod] | None = None,
    free_before: dict[str, tuple[float, float, float]] | None = None,
    released: dict[str, tuple[float, float, float]] | None = None,
) -> list[Violation]:
    """All post-tick checks; ``free_before``/``released`` enable the
    solver-level fit check for this tick's fresh bindings."""
    out: list[Violation] = []
    sizecars = _sizecars(pods)

    # ---- no double-bind ----
    owners: dict[int, str] = {}
    for p in sizecars:
        if p.spec.node_name and not p.spec.placement_hint:
            out.append(
                Violation(tick, "no_double_bind", f"{p.name} bound without hints")
            )
        if p.spec.placement_hint and not p.spec.node_name:
            out.append(
                Violation(tick, "no_double_bind", f"{p.name} hinted but unbound")
            )
        for jid in p.status.job_ids:
            if jid in owners:
                out.append(
                    Violation(
                        tick,
                        "no_double_bind",
                        f"job {jid} owned by {owners[jid]} and {p.name}",
                    )
                )
            owners[jid] = p.name

    # ---- gang atomicity ----
    for p in sizecars:
        d = p.spec.demand
        if d is None or not p.spec.node_name:
            continue
        k = max(1, d.nodes)
        hints = p.spec.placement_hint
        if len(hints) != k or len(set(hints)) != k:
            out.append(
                Violation(
                    tick,
                    "gang_atomicity",
                    f"{p.name} wants {k} nodes, hints {hints!r}",
                )
            )

    # ---- capacity never oversubscribed (ground truth) ----
    usage: dict[str, list[float]] = {
        name: [0.0, 0.0, 0.0] for name in cluster.nodes
    }
    for job in cluster.running_jobs():
        for node in job.assigned:
            u = usage[node]
            u[0] += job.cpus_per_node
            u[1] += job.mem_per_node_mb
            u[2] += job.gpus_per_node
    for name, node in cluster.nodes.items():
        u = usage[name]
        if (
            node.base_alloc_cpus + u[0] > node.cpus + 1e-6
            or node.base_alloc_memory_mb + u[1] > node.memory_mb + 1e-6
            or u[2] > node.gpus + 1e-6
        ):
            out.append(
                Violation(
                    tick,
                    "capacity",
                    f"node {name} oversubscribed: {u} over "
                    f"({node.cpus},{node.memory_mb},{node.gpus})",
                )
            )

    # ---- solver-level fit of this tick's fresh bindings ----
    if newly_bound and free_before is not None:
        bound_usage: dict[str, list[float]] = {}
        for p in newly_bound:
            d = p.spec.demand
            if d is None:
                continue
            cpu, mem, gpu = per_node_demand(d)
            for node in p.spec.placement_hint:
                u = bound_usage.setdefault(node, [0.0, 0.0, 0.0])
                u[0] += cpu
                u[1] += mem
                u[2] += gpu
        for node, u in bound_usage.items():
            free = free_before.get(node)
            if free is None:
                out.append(
                    Violation(
                        tick, "capacity", f"bound to unknown node {node!r}"
                    )
                )
                continue
            rel = (released or {}).get(node, (0.0, 0.0, 0.0))
            have = [free[i] + rel[i] for i in range(3)]
            if any(u[i] > have[i] + 1e-3 for i in range(3)):
                out.append(
                    Violation(
                        tick,
                        "capacity",
                        f"tick bindings oversubscribe {node}: "
                        f"need {u}, free {have}",
                    )
                )

    if out:
        _violations_total.inc(len(out))
    return out


def check_drain(
    tick: int, pending_pods: int, sim_pending: int, *, expect_drain: bool
) -> list[Violation]:
    """Scenario-end drain check: the scheduler queue AND the simulated
    Slurm queue must both be empty once arrivals stop and faults clear."""
    if not expect_drain:
        return []
    out = []
    if pending_pods:
        out.append(
            Violation(
                tick, "eventual_drain", f"{pending_pods} pods still pending"
            )
        )
    if sim_pending:
        out.append(
            Violation(
                tick,
                "eventual_drain",
                f"{sim_pending} slurm jobs still queued",
            )
        )
    if out:
        _violations_total.inc(len(out))
    return out
