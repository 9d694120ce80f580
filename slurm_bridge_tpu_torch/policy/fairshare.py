"""Weighted dominant-resource fair share across tenants.

The admission order *within* a priority class is not FIFO-by-priority:
tenants take turns weighted by quota, ordered by dominant-resource
deficit (DRF — Ghodsi et al., re-used here as the deterministic tick-
local ordering rule). Each tenant's accumulated service is its granted
dominant-resource share (max over resource dims of demand/cluster
capacity), divided by its weight; the tenant with the smallest share
goes next, and the planned grant is charged immediately so one tenant
with a deep queue cannot monopolize a tick.

Everything is deterministic: ties break on tenant name, then job
priority (descending), then job name.
"""

from __future__ import annotations

import heapq

import numpy as np


def jain_index(values) -> float:
    """Jain's fairness index over per-tenant (weighted) service values:
    (Σx)² / (n·Σx²) — 1.0 is perfectly fair, 1/n is one-tenant-takes-all.
    Empty or all-zero input reads as perfectly fair (nothing granted,
    nothing unfair)."""
    xs = np.asarray(list(values), dtype=np.float64)
    if xs.size == 0:
        return 1.0
    total = float(xs.sum())
    if total <= 0.0:
        return 1.0
    return float(total * total / (xs.size * float((xs * xs).sum())))


def dominant_share(demand_vec, totals) -> float:
    """max_r demand_r / capacity_r over the resource dims with nonzero
    cluster capacity — one job's dominant-resource share."""
    share = 0.0
    for d, t in zip(demand_vec, totals):
        if t > 0:
            share = max(share, float(d) / float(t))
    return share


class FairShare:
    """Per-tenant weighted service accumulator + DRF ordering.

    ``usage`` persists across ticks (service granted so far this run);
    :meth:`order` additionally charges planned grants within the tick so
    the produced order interleaves tenants even from a cold start.
    """

    def __init__(self, weights: dict[str, float] | None = None):
        #: tenant → quota weight (missing tenants weigh 1.0)
        self.weights = dict(weights or {})
        #: tenant → accumulated dominant-share service (unweighted)
        self.usage: dict[str, float] = {}

    def weight(self, tenant: str) -> float:
        w = self.weights.get(tenant, 1.0)
        return w if w > 0 else 1.0

    def charge(self, tenant: str, share: float) -> None:
        self.usage[tenant] = self.usage.get(tenant, 0.0) + share

    def order(self, jobs: list[tuple[str, float, float, str]]) -> list[int]:
        """DRF order over one class's jobs.

        ``jobs[i] = (tenant, dominant_share, spec_priority, name)``.
        Returns the indices of ``jobs`` in admission order: repeatedly
        pick the tenant with the smallest planned weighted share and
        admit its best remaining job (priority desc, name asc).
        """
        queues: dict[str, list[int]] = {}
        for i, (tenant, _share, _prio, _name) in enumerate(jobs):
            queues.setdefault(tenant, []).append(i)
        for tenant, idxs in queues.items():
            idxs.sort(key=lambda i: (-jobs[i][2], jobs[i][3]))
            idxs.reverse()  # pop() from the end = best first
        heap = [
            (self.usage.get(t, 0.0) / self.weight(t), t)
            for t in sorted(queues)
        ]
        heapq.heapify(heap)
        out: list[int] = []
        while heap:
            share, tenant = heapq.heappop(heap)
            idxs = queues[tenant]
            i = idxs.pop()
            out.append(i)
            if idxs:
                heapq.heappush(
                    heap,
                    (share + jobs[i][1] / self.weight(tenant), tenant),
                )
        return out
