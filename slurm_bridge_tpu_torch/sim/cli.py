"""``python -m slurm_bridge_tpu_torch.sim`` — run simulation scenarios.

    python -m slurm_bridge_tpu_torch.sim --list
    python -m slurm_bridge_tpu_torch.sim steady_poisson node_churn --seed 7
    python -m slurm_bridge_tpu_torch.sim --all --scale 0.25
    python -m slurm_bridge_tpu_torch.sim --smoke          # the `make sim-smoke` gate
    python -m slurm_bridge_tpu_torch.sim full_50kx10k     # slow headline (minutes)
    python -m slurm_bridge_tpu_torch.sim sharded_gang_split --explain job-000007
                                    # one job's placement decision trail

One JSON object per scenario on stdout; ``--out`` additionally writes the
array to a file. The headline scenario also emits a one-line
``{"metric": "full_tick_p50_ms_50kx10k", ...}`` record, bench.py-style.

``--smoke`` runs every fast scenario at a toy scale TWICE with the same
seed and fails (exit 1) unless (a) the deterministic metrics sections are
byte-identical, (b) no invariant was violated, and (c) every fault
scenario that expects to drain actually recovered — the CI determinism +
recovery gate.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from slurm_bridge_tpu_torch.sim.harness import SimHarness, run_scenario
from slurm_bridge_tpu_torch.sim.scenarios import (
    ADMISSION_SCENARIOS,
    CHAOS_SCENARIOS,
    FLEET_SCENARIOS,
    QUALITY_SCENARIOS,
    SCENARIOS,
    SHARD_SCENARIOS,
    SMOKE_SCENARIOS,
)

SMOKE_SCALE = 0.12

#: quality-smoke floors (ISSUE 9 acceptance): the fairness split the
#: multi-tenant storm must show, the utilization margin backfill must
#: buy on diurnal load, and the wait bound the production gang must make
QUALITY_GATES = {
    "jain_on_floor": 0.9,
    "jain_off_ceiling": 0.7,
    "util_margin": 0.02,
    "max_wait_ticks": 3.0,
}

#: admission-smoke floors/ceilings (ISSUE 12 acceptance): the
#: interactive arrival→bind p99 the fast path must hold (virtual time —
#: a batch-tick bind costs ≥ half a tick period, so the ceiling is only
#: reachable through the fast path), the batch-utilization margin the
#: admission-off twin comparison allows, and the minimum fast-path
#: engagement below which the scenario stopped testing anything
ADMISSION_GATES = {
    "p99_ms": 100.0,
    "util_margin": 0.01,
    "min_fastpath_binds": 10,
}


def _build(name: str, *, seed: int | None, scale: float, ticks: int | None):
    sc = SCENARIOS[name](scale=scale, **({"seed": seed} if seed is not None else {}))
    if ticks is not None:
        sc = dataclasses.replace(sc, ticks=ticks)
    return sc


def _headline(result) -> dict:
    t = result.timing
    return {
        "metric": f"full_tick_p50_ms_{result.shape['pods'] // 1000}kx"
        f"{result.shape['nodes'] // 1000}k",
        "value": t["tick_p50_ms"],
        "unit": "ms",
        "p95_ms": t["tick_p95_ms"],
        "steady_tick_p50_ms": t.get("steady_tick_p50_ms"),
        "steady_ticks": t.get("steady_ticks"),
        "phases_p50_ms": t["phases_p50_ms"],
        # the per-phase split under its contract name, so BENCH json
        # consumers can track phase-level regressions (PR-3 satellite)
        "full_tick_phases_ms": t["phases_p50_ms"],
        "pods": result.shape["pods"],
        "nodes": result.shape["nodes"],
        "bound_total": result.determinism["bound_total"],
        "submits_batched": result.determinism["submits_batched"],
        "submits_fallback": result.determinism["submits_fallback"],
        "invariant_violations": len(result.determinism["invariant_violations"]),
        # the tick flight record: span-tree p50s, top self-time, per-kind
        # × per-callsite commit breakdown — the attribution dataset the
        # store decision (ROADMAP) needs
        "flight_record": result.flight_record,
    }


def _write_flight_diagnostics(result) -> str | None:
    """Per-tick flight records for the slow headline run →
    ``diagnostics/sim_flight_<scenario>.json`` (repo-relative when run
    from a checkout, cwd otherwise)."""
    import os

    if not result.flight_ticks:
        return None
    out_dir = "diagnostics"
    path = os.path.join(out_dir, f"sim_flight_{result.scenario.name}.json")
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(
                {
                    "scenario": result.scenario.name,
                    "seed": result.scenario.seed,
                    "aggregate": result.flight_record,
                    "per_tick": result.flight_ticks,
                },
                f,
                indent=1,
                sort_keys=True,
            )
    except OSError:
        # read-only checkout: the diagnostics artifact degrades to the
        # in-JSON aggregate; never abort the run over it
        return None
    return path


def _smoke(names: tuple[str, ...] = SMOKE_SCENARIOS, label: str = "sim-smoke") -> int:
    from slurm_bridge_tpu_torch.sim.faults import AGENT_KINDS, BRIDGE_KINDS

    failures: list[str] = []
    for name in names:
        runs = []
        for _ in range(2):
            sc = _build(name, seed=None, scale=SMOKE_SCALE, ticks=None)
            runs.append(run_scenario(sc))
        a, b = runs
        det_a, det_b = a.determinism_json(), b.determinism_json()
        plan_kinds = {f.kind for f in a.scenario.faults.faults}
        bridge_faulted = bool(plan_kinds & set(BRIDGE_KINDS))
        agent_faulted = bool(plan_kinds & set(AGENT_KINDS))
        wait_reasons = a.quality.get("wait_reasons", {})
        line = {
            "scenario": name,
            "deterministic": det_a == det_b,
            "wait_reasons": wait_reasons,
            "violations": len(a.determinism["invariant_violations"]),
            "bound_total": a.determinism["bound_total"],
            "pending_final": a.determinism["pending_final"],
            "recovery_ticks": a.determinism["recovery_ticks"],
            "restarts": a.determinism["restarts"],
            "agent_restarts": a.determinism["agent_restarts"],
            "vnode_deletions": a.determinism["vnode_deletions"],
            "rpc_retries": sum(a.determinism["rpc_retries"].values()),
            "tick_p50_ms": a.timing["tick_p50_ms"],
            # flight-record glance: span-derived phase sum should track
            # tick_p50_ms (the ±5% reconciliation the tests enforce)
            "flight_phase_sum_p50_ms": a.flight_record.get("phase_sum_p50_ms"),
            "flight_commits_total": a.flight_record.get("commits_total"),
        }
        if a.scenario.sharding is not None:
            line["shard"] = a.determinism.get("shard")
        print(json.dumps(line))
        if det_a != det_b:
            failures.append(f"{name}: determinism broke (same seed, different run)")
        if a.determinism["invariant_violations"]:
            first = a.determinism["invariant_violations"][0]
            failures.append(f"{name}: invariant violated: {first}")
        if a.scenario.explain and wait_reasons.get("UNKNOWN"):
            # ISSUE 15 acceptance: with explain on, every unplaced job
            # carries a STRUCTURED reason — an UNKNOWN leaking through
            # means an attribution-less mark path regressed
            failures.append(
                f"{name}: {wait_reasons['UNKNOWN']} unplaced job-ticks "
                "fell back to the generic UNKNOWN reason with explain on"
            )
        if name == "sharded_gang_split" and a.scenario.explain and not wait_reasons:
            failures.append(
                f"{name}: no wait_reasons recorded — the explain plane "
                "is dead on the sharded tick"
            )
        if a.scenario.faults and a.scenario.expect_drain:
            rec = a.determinism["recovery_ticks"]
            bound = a.scenario.max_recovery_ticks
            if rec is None:
                failures.append(f"{name}: never recovered after fault window")
            elif bound is not None and rec > bound:
                failures.append(
                    f"{name}: recovery_ticks {rec} over the scenario "
                    f"bound {bound}"
                )
        if bridge_faulted:
            # a restart/failover may NEVER flap virtual nodes (ADVICE #1
            # under the new path) and must actually have happened
            if a.determinism["vnode_deletions"]:
                failures.append(
                    f"{name}: {a.determinism['vnode_deletions']} VirtualNode "
                    "deletions across a restart/failover (must be 0)"
                )
            if not a.determinism["restarts"]:
                failures.append(f"{name}: bridge fault never restarted the stack")
        if agent_faulted and not a.determinism["agent_restarts"]:
            failures.append(f"{name}: agent fault never reloaded the agent")
        if a.scenario.lossless_twin:
            # lossless recovery: the crashed run must END identical to
            # the same scenario with the bridge/agent crash faults
            # stripped (remaining chaos — rpc flaps, vanished partitions
            # — stays in the twin, isolating the crash's contribution).
            # "state" compares byte-identical placements+ids; "outcome"
            # the id/placement-insensitive lifecycle digest (composed
            # RPC faults legitimately reshuffle Slurm job ids).
            key = (
                "final_state_digest"
                if a.scenario.lossless_twin == "state"
                else "final_outcome_digest"
            )
            twin = run_scenario(
                dataclasses.replace(
                    a.scenario,
                    faults=a.scenario.faults.strip(BRIDGE_KINDS + AGENT_KINDS),
                )
            )
            same = twin.determinism[key] == a.determinism[key]
            print(json.dumps({
                "scenario": f"{name}[crash-free twin]",
                "compared": key,
                "final_identical": same,
            }))
            if not same:
                failures.append(
                    f"{name}: post-recovery {key} diverged from the "
                    "crash-free run at the same seed"
                )
        if a.scenario.incremental:
            # the PR-11 acceptance gate: the event-driven incremental
            # tick must be byte-identical IN OUTCOME to the full tick —
            # same determinism digest (every bind/preempt/pending count,
            # in order) and same final state — at the same seed, faults
            # included. O(changes) may only change WHERE time goes.
            off = run_scenario(
                dataclasses.replace(a.scenario, incremental=False)
            )
            inc_same = (
                off.determinism["digest"] == a.determinism["digest"]
                and off.determinism["final_state_digest"]
                == a.determinism["final_state_digest"]
            )
            print(json.dumps({
                "scenario": f"{name}[full-tick twin]",
                "incremental_identical": inc_same,
                "steady_ticks": a.timing.get("steady_ticks"),
                "steady_tick_p50_ms": a.timing.get("steady_tick_p50_ms"),
            }))
            if not inc_same:
                failures.append(
                    f"{name}: incremental tick diverged from the full "
                    "tick at the same seed"
                )
        if a.scenario.sharding is not None:
            # shard-specific gates: the plan must actually shard, and
            # the reconciliation scenario must actually reconcile —
            # either degrading silently would leave the subsystem
            # untested while the smoke line stays green
            sh = a.determinism.get("shard") or {}
            if (sh.get("shard_count") or 0) < 2:
                failures.append(
                    f"{name}: sharding on but the plan built "
                    f"{sh.get('shard_count')} shard(s) — the fan-out "
                    "never engaged"
                )
            if name == "sharded_gang_split" and not sh.get(
                "reconcile_placed"
            ):
                failures.append(
                    f"{name}: no gang placed via cross-shard "
                    "reconciliation — the pass is dead"
                )
    if failures:
        for f in failures:
            print(f"# {label} FAIL: {f}", file=sys.stderr)
        return 1
    print(f"# {label} OK: {len(names)} scenarios, deterministic, "
          "invariants held", file=sys.stderr)
    return 0


def _quality(label: str = "quality-smoke") -> int:
    """The placement-quality gate (ISSUE 9): each quality scenario runs
    TWICE (determinism over the scorecard too), then its policy-off —
    and, for diurnal, backfill-off — twin arms run at the same seed and
    the scorecard floors are enforced:

    - ``multi_tenant_storm``: Jain ≥ 0.9 with fair share on, < 0.7
      under the priority-FIFO baseline;
    - ``priority_inversion``: the production gang binds within
      ``max_wait_ticks`` via ≥1 preemption; the policy-off arm starves
      it (recorded);
    - ``diurnal_load``: utilization beats policy-off by the margin,
      backfill actually fired, and gang waits beat the backfill-off arm;
    - ``elastic_resize``: every resized job re-places, the scenario
      drains, zero invariant violations.
    """
    import dataclasses

    from slurm_bridge_tpu_torch.policy.engine import PolicyConfig

    g = QUALITY_GATES
    failures: list[str] = []

    def run(name: str, **replace):
        sc = SCENARIOS[name](scale=SMOKE_SCALE)
        if replace:
            sc = dataclasses.replace(sc, **replace)
        return run_scenario(sc)

    for name in QUALITY_SCENARIOS:
        a = run(name)
        b = run(name)
        det = (
            a.determinism_json() == b.determinism_json()
            and a.quality == b.quality
        )
        if not det:
            failures.append(f"{name}: determinism broke (same seed, "
                            "different run — scorecard or digest)")
        if a.determinism["invariant_violations"]:
            first = a.determinism["invariant_violations"][0]
            failures.append(f"{name}: invariant violated: {first}")
        if a.scenario.incremental:
            # PR-11: the incremental tick must not move a single quality
            # number either — same digest, same final state, same
            # scorecard as the full tick at the same seed
            full = run(name, incremental=False)
            inc_same = (
                full.determinism["digest"] == a.determinism["digest"]
                and full.determinism["final_state_digest"]
                == a.determinism["final_state_digest"]
                and full.quality == a.quality
            )
            if not inc_same:
                failures.append(
                    f"{name}: incremental tick diverged from the full "
                    "tick (digest/state/scorecard) at the same seed"
                )
        q = a.quality
        line = {
            "scenario": name,
            "deterministic": det,
            "violations": len(a.determinism["invariant_violations"]),
            "bound_total": a.determinism["bound_total"],
            "utilization_mean": q["utilization_mean"],
            "jain_fairness": q["jain_fairness"],
            "gang_wait_p95_ticks": q["gang_wait_p95_ticks"],
            "preempted_total": q["preempted_total"],
            "backfill_binds": q.get("backfill_binds"),
            "resizes": q["resizes"],
            "wait_reasons": q.get("wait_reasons", {}),
        }
        if a.scenario.explain and q.get("wait_reasons", {}).get("UNKNOWN"):
            failures.append(
                f"{name}: {q['wait_reasons']['UNKNOWN']} unplaced "
                "job-ticks carry the generic UNKNOWN reason with "
                "explain on"
            )
        if name == "multi_tenant_storm" and a.scenario.explain and not q.get(
            "wait_reasons"
        ):
            failures.append(
                f"{name}: no wait_reasons recorded — the explain plane "
                "is dead on the oversubscribed storm"
            )

        if name == "multi_tenant_storm":
            off = run(name, policy=None)
            line["jain_policy_off"] = off.quality["jain_fairness"]
            if q["jain_fairness"] < g["jain_on_floor"]:
                failures.append(
                    f"{name}: Jain {q['jain_fairness']} under the "
                    f"{g['jain_on_floor']} fair-share floor"
                )
            if off.quality["jain_fairness"] >= g["jain_off_ceiling"]:
                failures.append(
                    f"{name}: policy-off Jain {off.quality['jain_fairness']} "
                    f"not under {g['jain_off_ceiling']} — the baseline "
                    "stopped being unfair, the comparison is vacuous"
                )
        elif name == "priority_inversion":
            off = run(name, policy=None)
            on_wait = q["class_wait_p95_ticks"].get("production")
            off_wait = off.quality["class_wait_p95_ticks"].get("production")
            line["production_wait_p95"] = on_wait
            line["production_wait_p95_policy_off"] = off_wait
            if on_wait is None or on_wait > g["max_wait_ticks"]:
                failures.append(
                    f"{name}: production gang wait p95 {on_wait} over the "
                    f"{g['max_wait_ticks']}-tick bound"
                )
            if q["preempted_total"] < 1:
                failures.append(
                    f"{name}: gang bound without preempting anyone — the "
                    "scenario no longer exercises class preemption"
                )
            if off_wait is not None and on_wait is not None \
                    and off_wait <= on_wait:
                failures.append(
                    f"{name}: policy-off wait {off_wait} not worse than "
                    f"policy-on {on_wait} — no inversion to fix"
                )
        elif name == "diurnal_load":
            off = run(name, policy=None)
            nobf = run(name, policy=PolicyConfig(backfill=False))
            line["utilization_policy_off"] = off.quality["utilization_mean"]
            line["utilization_backfill_off"] = nobf.quality["utilization_mean"]
            line["gang_wait_p95_backfill_off"] = nobf.quality[
                "gang_wait_p95_ticks"
            ]
            if q["utilization_mean"] < (
                off.quality["utilization_mean"] + g["util_margin"]
            ):
                failures.append(
                    f"{name}: utilization {q['utilization_mean']} not "
                    f"{g['util_margin']} over policy-off "
                    f"{off.quality['utilization_mean']}"
                )
            if not q.get("backfill_binds"):
                failures.append(f"{name}: backfill never placed anything")
            if q["gang_wait_p95_ticks"] >= nobf.quality["gang_wait_p95_ticks"]:
                failures.append(
                    f"{name}: gang wait p95 {q['gang_wait_p95_ticks']} not "
                    "under the backfill-off arm "
                    f"{nobf.quality['gang_wait_p95_ticks']} — backfill "
                    "isn't what starts the gangs"
                )
        elif name == "elastic_resize":
            if not q["resizes"]:
                failures.append(f"{name}: no resizes applied")
            if a.determinism["drained_at_tick"] is None:
                failures.append(f"{name}: resized workload never drained")
            if q["unbound_final"]:
                failures.append(
                    f"{name}: {q['unbound_final']} jobs never re-placed "
                    "after resize"
                )
            rec = a.determinism["recovery_ticks"]
            bound = a.scenario.max_recovery_ticks
            if rec is None or (bound is not None and rec > bound):
                failures.append(
                    f"{name}: recovery_ticks {rec} over bound {bound}"
                )
        print(json.dumps(line))
    if failures:
        for f in failures:
            print(f"# {label} FAIL: {f}", file=sys.stderr)
        return 1
    print(
        f"# {label} OK: {len(QUALITY_SCENARIOS)} scenarios, deterministic, "
        "scorecard floors held", file=sys.stderr,
    )
    return 0


def _stitch_coverage(result) -> tuple[float, float]:
    """Summed ``(stitched child ms, total ms)`` over every
    ``rpc.client.PlaceShard`` node in the run's per-tick flight trees —
    the ISSUE 20 trace-coverage gate's numerator and denominator. The
    children are the synthetic ``sidecar.*`` phase spans plus the
    ``rpc.overhead`` residual the stitching hook fabricates while the
    client span is still open."""
    covered = 0.0
    total = 0.0

    def walk(name: str, node: dict) -> None:
        nonlocal covered, total
        if name == "rpc.client.PlaceShard":
            total += node.get("ms", 0.0)
            for child in node.get("children", {}).values():
                covered += child.get("ms", 0.0)
        for child_name, child in node.get("children", {}).items():
            walk(child_name, child)

    for rec in result.flight_ticks:
        for name, node in rec.get("tree", {}).items():
            walk(name, node)
    return covered, total


def _fleet(label: str = "fleet-smoke") -> int:
    """The fleet gate (ISSUE 17): each fleet scenario runs TWICE
    (double-run determinism — membership facts included), then its
    single-process twin at the same seed:

    - **fleet twin**: the fleet run's ``final_state_digest`` must be
      byte-identical to the same scenario with ``fleet=None`` and the
      ``kill_replica`` faults stripped — remote solves are byte-parity
      with inline and a re-key only changes WHO solves, so any
      divergence is a lost bind or a corrupted shard merge;
    - **engagement**: ``remote_solves > 0`` — a fleet run that silently
      solved everything inline is a failed gate, not a pass;
    - **chaos** (``fleet_kill_owner``): the kill actually happened, the
      dead replica's sidecar was re-adopted (``live_final`` back to
      full strength) within ``max_recovery_ticks``, and zero
      VirtualNode deletions (no node flap from a fleet event);
    - **trace coverage** (ISSUE 20): ≥95% of every
      ``rpc.client.PlaceShard`` span's wall time is attributed to the
      stitched synthetic children (``sidecar.decode/solve/encode`` +
      the ``rpc.overhead`` residual) — unexplained client-span time
      means the stitching hook fell off the RPC path.
    """
    from slurm_bridge_tpu_torch.sim.faults import FLEET_KINDS

    failures: list[str] = []
    for name in FLEET_SCENARIOS:
        runs = []
        for _ in range(2):
            sc = _build(name, seed=None, scale=SMOKE_SCALE, ticks=None)
            runs.append(run_scenario(sc))
        a, b = runs
        det_a, det_b = a.determinism_json(), b.determinism_json()
        fleet = a.determinism.get("fleet") or {}
        remote = a.quality.get("fleet_remote") or {}
        line = {
            "scenario": name,
            "deterministic": det_a == det_b,
            "violations": len(a.determinism["invariant_violations"]),
            "bound_total": a.determinism["bound_total"],
            "pending_final": a.determinism["pending_final"],
            "vnode_deletions": a.determinism["vnode_deletions"],
            "fleet": fleet,
            "fleet_remote": remote,
            "tick_p50_ms": a.timing["tick_p50_ms"],
        }
        print(json.dumps(line))
        if det_a != det_b:
            failures.append(f"{name}: determinism broke (same seed, different run)")
        if a.determinism["invariant_violations"]:
            first = a.determinism["invariant_violations"][0]
            failures.append(f"{name}: invariant violated: {first}")
        if not remote.get("remote_solves"):
            failures.append(
                f"{name}: fleet attached but remote_solves == 0 — every "
                "shard solved inline, the gRPC path never engaged"
            )
        covered, total = _stitch_coverage(a)
        coverage = covered / total if total > 0 else 0.0
        print(json.dumps({
            "scenario": f"{name}[trace-stitching]",
            "place_shard_ms": round(total, 3),
            "stitched_ms": round(covered, 3),
            "coverage": round(coverage, 4),
            "fleet_timeline_events": len(
                (a.flight_record.get("fleet") or {}).get("timeline", [])
            ),
        }))
        if remote.get("remote_solves") and total > 0 and coverage < 0.95:
            failures.append(
                f"{name}: trace stitching covered {coverage:.1%} of "
                "rpc.client.PlaceShard wall time (floor 95%) — the "
                "synthetic sidecar children + rpc.overhead residual "
                "left client-span time unexplained"
            )
        if not (a.flight_record.get("fleet") or {}).get("timeline"):
            failures.append(
                f"{name}: flight record carries no fleet lifecycle "
                "timeline — spawn/ready events never recorded"
            )
        twin = run_scenario(
            dataclasses.replace(
                a.scenario,
                fleet=None,
                faults=a.scenario.faults.strip(FLEET_KINDS),
            )
        )
        same = (
            twin.determinism["final_state_digest"]
            == a.determinism["final_state_digest"]
        )
        print(json.dumps({
            "scenario": f"{name}[single-process twin]",
            "compared": "final_state_digest",
            "final_identical": same,
        }))
        if not same:
            failures.append(
                f"{name}: final_state_digest diverged from the single-"
                "process run at the same seed — a remote solve or "
                "re-key changed placements"
            )
        if name == "fleet_kill_owner":
            if not fleet.get("kills"):
                failures.append(f"{name}: kill_replica fault never killed anyone")
            if fleet.get("live_final") != fleet.get("replicas"):
                failures.append(
                    f"{name}: fleet ended at {fleet.get('live_final')}/"
                    f"{fleet.get('replicas')} live — the killed replica "
                    "was never re-adopted"
                )
            bound = a.scenario.max_recovery_ticks
            rec = fleet.get("recovery_ticks", 0)
            if bound is not None and rec > bound:
                failures.append(
                    f"{name}: fleet recovery_ticks {rec} over the "
                    f"scenario bound {bound}"
                )
            if a.determinism["vnode_deletions"]:
                failures.append(
                    f"{name}: {a.determinism['vnode_deletions']} "
                    "VirtualNode deletions across a replica kill (must be 0)"
                )
    if failures:
        for f in failures:
            print(f"# {label} FAIL: {f}", file=sys.stderr)
        return 1
    print(
        f"# {label} OK: {len(FLEET_SCENARIOS)} scenarios, deterministic, "
        "fleet twins byte-identical, chaos re-key held", file=sys.stderr,
    )
    return 0


def _admission(label: str = "admission-smoke") -> int:
    """The streaming-admission gate (ISSUE 12): each admission scenario
    runs TWICE (double-run determinism over the decision stream —
    attempts, binds, misses, digests), then its twin arms at the same
    seed:

    - **latency**: interactive arrival→bind p99 ≤ ``p99_ms`` in virtual
      time. Fast-path binds cost their measured admission wall time
      (sub-ms); a batch-tick bind costs at least half a tick period
      (2.5 s here) — so the gate holds only if the fast path catches
      essentially every interactive arrival;
    - **engagement**: the fast path actually bound ≥ the floor — a
      silently-dormant admitter is a failed gate, not a pass;
    - **admission-off twin**: batch utilization within ``util_margin``
      of the same scenario with ``admission=None`` (the fast path must
      not wreck the packing it front-runs), and the twin's interactive
      p99 must be OVER the gate — otherwise the comparison is vacuous;
    - **full-tick twin**: the incremental tick under admission stays
      byte-identical in outcome to the full tick, same as every other
      subsystem.
    """
    import dataclasses

    g = ADMISSION_GATES
    failures: list[str] = []
    for name in ADMISSION_SCENARIOS:
        runs = [
            run_scenario(_build(name, seed=None, scale=SMOKE_SCALE, ticks=None))
            for _ in range(2)
        ]
        a, b = runs
        det = a.determinism_json() == b.determinism_json()
        q = a.quality
        adm = a.determinism.get("admission") or {}
        line = {
            "scenario": name,
            "deterministic": det,
            "violations": len(a.determinism["invariant_violations"]),
            "bound_total": a.determinism["bound_total"],
            "interactive_arrivals": q["interactive_arrivals"],
            "fastpath_binds": q["fastpath_binds"],
            "interactive_latency_p50_ms": q["interactive_latency_p50_ms"],
            "interactive_latency_p99_ms": q["interactive_latency_p99_ms"],
            "admission": adm,
            "utilization_mean": q["utilization_mean"],
        }
        if not det:
            failures.append(
                f"{name}: determinism broke (same seed, different run)"
            )
        if a.determinism["invariant_violations"]:
            first = a.determinism["invariant_violations"][0]
            failures.append(f"{name}: invariant violated: {first}")
        if q["interactive_latency_p99_ms"] > g["p99_ms"]:
            failures.append(
                f"{name}: interactive p99 {q['interactive_latency_p99_ms']} "
                f"ms over the {g['p99_ms']} ms gate"
            )
        if q["fastpath_binds"] < g["min_fastpath_binds"]:
            failures.append(
                f"{name}: only {q['fastpath_binds']} fast-path binds "
                f"(floor {g['min_fastpath_binds']}) — the fast path is "
                "dormant"
            )
        if not adm.get("misses"):
            # ISSUE 15 satellite: the by-reason miss ledger must be
            # live in the scenario JSON — cold-start arrivals alone
            # guarantee no_window/not_ready entries, so an empty dict
            # means the accounting broke, not that nothing missed
            failures.append(
                f"{name}: FastPathAdmitter.misses is empty — the "
                "by-reason miss accounting is dead"
            )
        if q.get("admission_misses") != adm.get("misses"):
            failures.append(
                f"{name}: quality.admission_misses diverged from the "
                "admitter's own ledger"
            )
        off = run_scenario(
            dataclasses.replace(
                _build(name, seed=None, scale=SMOKE_SCALE, ticks=None),
                admission=None,
            )
        )
        line["utilization_admission_off"] = off.quality["utilization_mean"]
        line["p99_admission_off"] = off.quality.get(
            "interactive_latency_p99_ms"
        )
        if (
            abs(q["utilization_mean"] - off.quality["utilization_mean"])
            > g["util_margin"]
        ):
            failures.append(
                f"{name}: utilization {q['utilization_mean']} not within "
                f"{g['util_margin']} of the admission-off twin "
                f"{off.quality['utilization_mean']}"
            )
        # vacuity check on the LATENCY claim: with admission off the
        # same interactive stream must miss the gate (it binds through
        # the batch tick at ≥ half a tick period). The off arm tracks
        # no interactive set, so compute from its wait distribution:
        # every wait is ≥ 0 ticks ⇒ ≥ 2.5 s with the +0.5 model — the
        # arithmetic floor already exceeds the gate; assert it to keep
        # the gate honest if the latency model ever changes.
        half_tick_ms = a.scenario.tick_interval_s * 500.0
        if half_tick_ms <= g["p99_ms"]:
            failures.append(
                f"{name}: tick interval {a.scenario.tick_interval_s}s "
                "makes the batch path faster than the gate — the "
                "comparison is vacuous"
            )
        full = run_scenario(
            dataclasses.replace(
                _build(name, seed=None, scale=SMOKE_SCALE, ticks=None),
                incremental=False,
            )
        )
        inc_same = (
            full.determinism["digest"] == a.determinism["digest"]
            and full.determinism["final_state_digest"]
            == a.determinism["final_state_digest"]
        )
        line["incremental_identical"] = inc_same
        if not inc_same:
            failures.append(
                f"{name}: incremental tick diverged from the full tick "
                "under admission at the same seed"
            )
        print(json.dumps(line))
    if failures:
        for f in failures:
            print(f"# {label} FAIL: {f}", file=sys.stderr)
        return 1
    print(
        f"# {label} OK: {len(ADMISSION_SCENARIOS)} scenarios, "
        "deterministic, latency + utilization gates held", file=sys.stderr,
    )
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m slurm_bridge_tpu_torch.sim",
        description="deterministic cluster simulator + fault harness",
    )
    parser.add_argument("scenarios", nargs="*", help="scenario names (see --list)")
    parser.add_argument("--list", action="store_true", help="list scenarios")
    parser.add_argument("--all", action="store_true",
                        help="run every fast scenario")
    parser.add_argument("--smoke", action="store_true",
                        help="CI gate: toy scale, double-run determinism check")
    parser.add_argument("--chaos", action="store_true",
                        help="CI gate: only the composed-fault chaos "
                        "scenarios (double-run + crash-free twin digests)")
    parser.add_argument("--quality", action="store_true",
                        help="CI gate: the placement-quality scenarios "
                        "(double-run + policy-on/off arms + scorecard "
                        "floors — fairness, wait bounds, backfill)")
    parser.add_argument("--shard", action="store_true",
                        help="CI gate: the sharded-placement scenarios "
                        "(double-run determinism + invariants + shard/"
                        "reconcile engagement gates)")
    parser.add_argument("--admission", action="store_true",
                        help="CI gate: the streaming-admission scenarios "
                        "(double-run determinism + interactive latency "
                        "p99 + admission-off utilization twin)")
    parser.add_argument("--fleet", action="store_true",
                        help="CI gate: the fleet scenarios (double-run "
                        "determinism + single-process twin digest + "
                        "remote-solve engagement + kill-shard-owner "
                        "chaos re-key)")
    parser.add_argument("--sidecars", type=int, default=None, metavar="N",
                        help="override the fleet replica count for named "
                        "fleet scenarios (each replica owns a shard-set "
                        "and a solver sidecar process)")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--explain", default="", metavar="JOB",
                        help="render one job's placement decision trail "
                        "(route -> solve -> backfill/reconcile -> "
                        "reason) for the named job or sizecar pod; "
                        "requires exactly one scenario")
    parser.add_argument("--scale", type=float, default=1.0,
                        help="multiply pod/node counts (default 1.0)")
    parser.add_argument("--ticks", type=int, default=None)
    parser.add_argument("--out", default="",
                        help="also write the result array to this JSON file")
    args = parser.parse_args(argv)

    if args.list:
        for name, f in SCENARIOS.items():
            sc = f()
            slow = " [slow]" if sc.slow else ""
            print(f"{name}{slow}: {sc.description}")
        return 0
    if args.chaos:
        return _smoke(CHAOS_SCENARIOS, label="chaos-smoke")
    if args.quality:
        return _quality()
    if args.shard:
        return _smoke(SHARD_SCENARIOS, label="shard-smoke")
    if args.admission:
        return _admission()
    if args.fleet:
        return _fleet()
    if args.smoke:
        return _smoke()

    names = args.scenarios or (
        # --all = every fast scenario, chaos + quality + shard subsets
        # included (the smoke GATES keep the sets disjoint; a human
        # asking for "all" wants all)
        [
            *SMOKE_SCENARIOS,
            *CHAOS_SCENARIOS,
            *QUALITY_SCENARIOS,
            *ADMISSION_SCENARIOS,
            *(n for n in SHARD_SCENARIOS if n not in SMOKE_SCENARIOS),
        ]
        if args.all
        else []
    )
    if not names:
        parser.error("name at least one scenario, or use --all / --smoke / --list")
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        parser.error(f"unknown scenarios {unknown}; see --list")

    if args.explain and len(names) != 1:
        parser.error("--explain traces one job through ONE scenario")

    results = []
    gate_failures: list[str] = []
    for name in names:
        sc = _build(name, seed=args.seed, scale=args.scale, ticks=args.ticks)
        if args.sidecars is not None:
            if sc.fleet is None:
                parser.error(
                    f"--sidecars only applies to fleet scenarios; "
                    f"{name} has no fleet config"
                )
            sc = dataclasses.replace(
                sc,
                fleet=dataclasses.replace(sc.fleet, replicas=args.sidecars),
            )
        if args.explain:
            # --explain <job>: trace one job's decision trail (ISSUE 15
            # sink 3). Accept the job name or the sizecar pod name —
            # the trail is recorded against the POD the scheduler sees.
            target = args.explain
            if not target.endswith("-sizecar"):
                target = f"{target}-sizecar"
            sc = dataclasses.replace(sc, explain_target=target)
        print(f"# running {name} "
              f"(~{sc.workload.jobs} jobs x {sc.cluster.num_nodes} nodes, "
              f"{sc.ticks} ticks)", file=sys.stderr, flush=True)
        if args.explain:
            harness = SimHarness(sc)
            result = harness.run()
            print(harness.scheduler.explain_trail.render(), flush=True)
        else:
            result = run_scenario(sc)
        results.append(result)
        print(json.dumps(result.as_dict()), flush=True)
        if name.startswith("full_") and "crash" not in name:
            # every full_* headline scenario emits its metric line +
            # flight diagnostics (full_50kx10k since PR-5, the sharded
            # full_500kx100k since PR-10)
            print(json.dumps(_headline(result)), flush=True)
            path = _write_flight_diagnostics(result)
            if path:
                print(f"# flight record: {path}", file=sys.stderr)
        if (
            sc.p50_gate_ms is not None
            and result.timing["tick_p50_ms"] > sc.p50_gate_ms
        ):
            gate_failures.append(
                f"{name}: tick_p50_ms {result.timing['tick_p50_ms']} over "
                f"the {sc.p50_gate_ms} ms gate"
            )
        if sc.phase_reconcile_pct is not None and sc.tracing:
            # the PR-5 ±5% flight-record contract, re-enforced at the
            # headline shape (ISSUE 14): the span-derived per-phase sum
            # must explain the tick span — a hollowed tree (dropped
            # spans, an unattributed phase) fails loudly instead of
            # silently lying about where the tick went
            fr = result.flight_record
            tick_span = fr.get("tick_span_p50_ms") or 0.0
            phase_sum = fr.get("phase_sum_p50_ms") or 0.0
            if tick_span <= 0.0:
                gate_failures.append(
                    f"{name}: phase_reconcile_pct set but no flight record"
                )
            elif (
                abs(tick_span - phase_sum) / tick_span * 100.0
                > sc.phase_reconcile_pct
            ):
                gate_failures.append(
                    f"{name}: phase_sum_p50_ms {phase_sum} vs tick span "
                    f"{tick_span} drifts over ±{sc.phase_reconcile_pct}%"
                )
        if sc.steady_gate_ms is not None and sc.incremental:
            steady = result.timing.get("steady_tick_p50_ms")
            if steady is None:
                gate_failures.append(
                    f"{name}: steady_gate_ms set but the run never "
                    "reached a steady tick"
                )
            elif steady > sc.steady_gate_ms:
                gate_failures.append(
                    f"{name}: steady_tick_p50_ms {steady} over the "
                    f"{sc.steady_gate_ms} ms gate"
                )
        if name == "full_50kx10k_crash":
            # the recovery-at-scale record BASELINE.md tracks
            print(json.dumps({
                "metric": "crash_recovery_ms_50kx10k",
                "recovery_ms": result.timing["recovery_ms"],
                "restored_objects": result.determinism["restored_objects"],
                "restarts": result.determinism["restarts"],
                "vnode_deletions": result.determinism["vnode_deletions"],
                "final_state_digest": result.determinism["final_state_digest"],
                "invariant_violations": len(
                    result.determinism["invariant_violations"]
                ),
            }), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump([r.as_dict() for r in results], f, indent=1, sort_keys=True)
    bad = [
        r.scenario.name
        for r in results
        if r.determinism["invariant_violations"]
    ]
    if bad:
        print(f"# invariant violations in: {', '.join(bad)}", file=sys.stderr)
        return 1
    if gate_failures:
        for f in gate_failures:
            print(f"# p50 gate FAIL: {f}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
