"""Placement-quality scorecard — what a sim scenario is scored on
besides speed (ISSUE 9: "placement quality as a first-class metric").

The harness feeds a :class:`QualityTracker` per tick (all virtual-time
data, fully deterministic) and the scorecard lands in the scenario JSON
next to ``tick_p50_ms``:

- **utilization** — allocated / total cpu over the run (mean + p50 of
  per-tick samples, sim ground truth);
- **fragmentation index** — the stranded-capacity measure from the
  constraint-packing literature (arxiv 2511.08373): the fraction of
  total free cpu sitting on nodes too small to host the reference job
  (the trace's median per-node cpu ask). 0 = every free cpu is usable,
  1 = all free capacity is dust;
- **gang wait-time p95** — ticks from arrival to bind, gang jobs
  (``nodes > 1``) tracked separately, never-bound jobs censored at run
  end and counted;
- **preemption churn** — total preempted + the worst single tick;
- **per-tenant fairness** — Jain index over weighted per-tenant service
  (allocated dominant-resource × virtual time, ground truth).
"""

from __future__ import annotations

import numpy as np

from slurm_bridge_tpu_torch.policy.fairshare import jain_index


def _pct(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    return round(float(np.percentile(np.asarray(xs, np.float64), q)), 3)


class QualityTracker:
    """Per-run quality accounting the sim harness drives.

    ``tenant_of`` / ``is_gang`` / ``class_of`` map BridgeJob names to
    trace facts; ``ref_cpu`` is the fragmentation reference demand (the
    trace's median per-node cpu ask). All inputs and samples are
    virtual-time deterministic.
    """

    def __init__(
        self,
        *,
        tenant_of: dict[str, str] | None = None,
        is_gang: dict[str, bool] | None = None,
        class_of: dict[str, str] | None = None,
        tenant_weights: dict[str, float] | None = None,
        ref_cpu: float = 1.0,
        tick_interval_s: float = 1.0,
    ):
        self.tenant_of = tenant_of or {}
        self.is_gang = is_gang or {}
        self.class_of = class_of or {}
        self.tenant_weights = tenant_weights or {}
        self.ref_cpu = max(1.0, float(ref_cpu))
        self.tick_interval_s = tick_interval_s
        self._arrived: dict[str, int] = {}  # job name -> arrival tick
        self._waits: list[tuple[str, int, bool]] = []  # (name, wait, bound)
        self._util: list[float] = []
        self._frag: list[float] = []
        self._preempts: list[int] = []
        self._service: dict[str, float] = {}
        self.resizes = 0
        # ---- streaming-admission latency axis (ISSUE 12) ----
        # Interactive (fast-path-eligible) arrivals tracked for the
        # arrival→bind latency scorecard. A fast-path bind's latency is
        # the measured wall time of the admission attempt (the path runs
        # event-driven at arrival — processing IS the wait); a batch
        # bind's latency is its virtual wait, (wait_ticks + 0.5) ×
        # tick_interval — the +0.5 models the expected wait for the
        # next periodic solve to even start, which the sim's synchronous
        # arrive-then-solve tick otherwise hides.
        self._interactive: set[str] = set()
        self._fastpath_ms: dict[str, float] = {}
        # ---- placement explainability (ISSUE 15) ----
        # Per-tick pressure ledgers from the scheduler's attribution
        # pass; the scorecard rolls them into ``wait_reasons`` —
        # job-ticks spent pending, by structured reason code — and the
        # top reason × partition × class × tenant cells.
        self._pressure: list[dict] = []

    # ---- per-event hooks ----

    def note_arrival(self, job_name: str, tick: int) -> None:
        self._arrived.setdefault(job_name, tick)

    def note_rearrival(self, job_name: str, tick: int) -> None:
        """A resize/requeue re-enters the queue: wait restarts (the
        re-placement latency is the interesting number)."""
        self._arrived[job_name] = tick

    def note_bound(self, job_name: str, tick: int) -> None:
        at = self._arrived.pop(job_name, None)
        if at is not None:
            self._waits.append((job_name, tick - at, True))

    def note_interactive(self, job_name: str) -> None:
        """One fast-path-ELIGIBLE arrival (admission on, class +
        gang-size eligible, past the cold-start warmup)."""
        self._interactive.add(job_name)

    def note_fastpath_bind(self, job_name: str, latency_ms: float) -> None:
        """The arrival bound via the fast path in ``latency_ms`` wall ms."""
        self._fastpath_ms[job_name] = float(latency_ms)

    def note_preempts(self, count: int) -> None:
        self._preempts.append(count)

    def note_pressure(self, ledger: dict) -> None:
        """One solve tick's pressure ledger (obs/explain.py schema)."""
        self._pressure.append(ledger)

    def note_resize(self) -> None:
        self.resizes += 1

    # ---- per-tick sampling (sim ground truth) ----

    def sample(self, cluster) -> None:
        """One tick's utilization/fragmentation/tenant-service sample
        from the sim cluster (duck-typed: ``nodes`` of SimNode,
        ``jobs`` of SimJob)."""
        total = alloc = free_total = stranded = 0.0
        for node in cluster.nodes.values():
            total += node.cpus
            a = min(node.cpus, node.alloc_cpus)
            alloc += a
            if not node.drained:
                f = node.cpus - a
                free_total += f
                if 0.0 < f < self.ref_cpu:
                    stranded += f
        self._util.append(alloc / total if total else 0.0)
        self._frag.append(stranded / free_total if free_total else 0.0)
        from slurm_bridge_tpu_torch.core.types import JobStatus

        dt = self.tick_interval_s
        for job in cluster.jobs.values():
            if job.state != JobStatus.RUNNING:
                continue
            tenant = self.tenant_of.get(job.name, "")
            self._service[tenant] = (
                self._service.get(tenant, 0.0)
                + job.cpus_per_node * job.num_nodes * dt
            )

    # ---- the scorecard ----

    def scorecard(self, final_tick: int, *, extra: dict | None = None) -> dict:
        # censor never-bound jobs at run end so an unbound gang shows up
        # as a LONG wait, not a missing sample
        waits = list(self._waits)
        unbound = 0
        for name, at in sorted(self._arrived.items()):
            waits.append((name, final_tick - at, False))
            unbound += 1
        all_w = [float(w) for _, w, _ in waits]
        gang_w = [float(w) for n, w, _ in waits if self.is_gang.get(n)]
        by_class: dict[str, list[float]] = {}
        for n, w, _ in waits:
            by_class.setdefault(self.class_of.get(n, ""), []).append(float(w))
        weighted = [
            s / max(self.tenant_weights.get(t, 1.0), 1e-9)
            for t, s in sorted(self._service.items())
        ]
        out = {
            "utilization_mean": round(float(np.mean(self._util)), 4)
            if self._util
            else 0.0,
            "utilization_p50": _pct(self._util, 50),
            "fragmentation_mean": round(float(np.mean(self._frag)), 4)
            if self._frag
            else 0.0,
            "wait_p50_ticks": _pct(all_w, 50),
            "wait_p95_ticks": _pct(all_w, 95),
            "wait_max_ticks": round(max(all_w), 3) if all_w else 0.0,
            "gang_wait_p95_ticks": _pct(gang_w, 95),
            "gang_wait_max_ticks": round(max(gang_w), 3) if gang_w else 0.0,
            "class_wait_p95_ticks": {
                c: _pct(ws, 95) for c, ws in sorted(by_class.items()) if c
            },
            "unbound_final": unbound,
            "preempted_total": int(sum(self._preempts)),
            "preempted_max_per_tick": int(max(self._preempts, default=0)),
            "tenant_service": {
                t: round(s, 3) for t, s in sorted(self._service.items())
            },
            "jain_fairness": round(jain_index(weighted), 4),
            "resizes": self.resizes,
        }
        # ---- interactive arrival→bind latency (ISSUE 12 gate axis) ----
        lat: list[float] = []
        tick_ms = self.tick_interval_s * 1e3
        by_name = {n: (w, b) for n, w, b in waits}
        for name in self._interactive:
            fast = self._fastpath_ms.get(name)
            if fast is not None:
                lat.append(fast)
                continue
            w, _bound = by_name.get(name, (float(final_tick), False))
            lat.append((float(w) + 0.5) * tick_ms)
        out["interactive_arrivals"] = len(self._interactive)
        out["fastpath_binds"] = len(self._fastpath_ms)
        out["interactive_latency_p50_ms"] = _pct(lat, 50)
        out["interactive_latency_p99_ms"] = _pct(lat, 99)
        # ---- wait-reason attribution (ISSUE 15 scorecard axis) ----
        # Job-ticks spent pending, by structured reason code — the
        # "WHY is work waiting" companion to the wait percentiles
        # above. Empty with explain off (or a run that never left
        # anything unplaced).
        from slurm_bridge_tpu_torch.obs.explain import merge_ledgers

        out.update(merge_ledgers(self._pressure))
        if extra:
            out.update(extra)
        return out
