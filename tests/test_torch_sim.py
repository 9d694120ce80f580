"""The port's simulator against the JAX package's, scenario for scenario.

The same scenario, seed and scale run through both packages' full bridge
loop — operator, configurator and virtual-node providers, placement
scheduler, simulated agent, fault client — on the CPU. The determinism
``digest`` (every bind, preemption and pending count, tick by tick) and
the ``final_state_digest`` (bindings, placements and lifecycle on both
sides of the wire) must be equal. No tolerance. The port also reproduces
the JAX package's pinned ``tests/fixtures/*_off_baseline.json`` digests,
run the way the JAX package's tests run them. Every scenario is a digest
twin, the two fleet scenarios included: their solver sidecars are real
worker processes of each package, spawned and killed over gRPC.

Every test resets both packages' forked worker pools when it ends.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest
import torch

import slurm_bridge_tpu.parallel.colpool as jax_colpool
import slurm_bridge_tpu.sim as jax_sim
import slurm_bridge_tpu.sim.harness as jax_harness
import slurm_bridge_tpu.sim.scenarios as jax_scenarios
import slurm_bridge_tpu.solver.auction as jax_auction
import slurm_bridge_tpu_torch.bridge.operator as port_operator
import slurm_bridge_tpu_torch.bridge.vnode as port_vnode
import slurm_bridge_tpu_torch.parallel.colpool as port_colpool
import slurm_bridge_tpu_torch.sim as port_sim
import slurm_bridge_tpu_torch.sim.harness as port_harness
import slurm_bridge_tpu_torch.sim.scenarios as port_scenarios
import slurm_bridge_tpu_torch.solver.auction as port_auction
from slurm_bridge_tpu_torch.parallel.backend import BackendUnavailable
from slurm_bridge_tpu_torch.wire.errors import RpcError, StatusCode

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
REPO = FIXTURES.parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _reap_pools(monkeypatch):
    """Two forked pool workers per run (the suite runs in parallel
    workers), and neither package's pool outlives a test."""
    monkeypatch.setenv("SBT_COLPOOL_WORKERS", "2")
    yield
    port_colpool.reset()
    jax_colpool.reset()


def _pinned_auction(sc, auction):
    """The headline's engine pinned, as chip_smoke.py runs it on the card."""
    return dataclasses.replace(
        sc, backend="auction",
        auction_config=auction.AuctionConfig(rounds=8, candidates=0),
    )


def _single_device_shards(sc):
    """Each shard on the single-device engine: the JAX package's tests run
    on eight virtual CPU devices, where a big shard would take its
    multi-device sweep, and the port here on one CPU device, where it
    would not (the sweep's digest twin is in tests/test_torch_sharded.py)."""
    if sc.sharding is None:
        return sc
    return dataclasses.replace(
        sc, sharding=dataclasses.replace(sc.sharding, device_solve=False)
    )


def _both(name: str, scale: float, *, pin_auction: bool = False, **replace):
    jsc = _single_device_shards(jax_scenarios.SCENARIOS[name](scale=scale))
    psc = _single_device_shards(port_scenarios.SCENARIOS[name](scale=scale))
    if pin_auction:
        jsc, psc = _pinned_auction(jsc, jax_auction), _pinned_auction(psc, port_auction)
    if replace:
        jsc, psc = dataclasses.replace(jsc, **replace), dataclasses.replace(psc, **replace)
    return jax_sim.run_scenario(jsc), port_sim.run_scenario(psc, device="cpu")


#: (scenario, scale, pin the auction): every scenario the port runs today,
#: at a scale that keeps each pair of runs to seconds
DIGEST_CASES = [
    ("steady_poisson", 0.05, False),
    ("burst_backlog", 0.05, False),
    ("agent_flaky_rpc", 0.05, False),
    ("preemption_storm", 0.12, False),
    ("node_churn", 0.05, False),
    ("partition_vanish", 0.05, False),
    ("diurnal_load", 0.12, False),  # its own config pins the auction
    ("multi_tenant_storm", 0.05, False),
    ("priority_inversion", 0.12, False),
    ("elastic_resize", 0.05, False),
    ("interactive_storm", 0.05, False),
    ("steady_state_soak", 0.1, False),
    ("full_50kx10k", 0.02, False),
    ("full_50kx10k", 0.02, True),  # chip_smoke.py's configuration
    ("full_50kx10k_steady", 0.02, False),
    # persistence, leader election and the agent journal
    ("crash_restart", 0.05, False),
    ("leader_failover", 0.05, False),
    ("agent_crash", 0.05, False),
    ("chaos_dual_crash", 0.05, False),
    ("chaos_crash_rpc_flap", 0.05, False),
    ("chaos_crash_into_vanished_partition", 0.05, False),
    ("full_50kx10k_crash", 0.02, True),  # chip_smoke.py's configuration
    # the sharded tick: the executor, its fan-out and the reconcile pass
    ("sharded_smoke", 0.05, False),
    ("sharded_gang_split", 0.1, False),
    ("full_500kx100k", 0.004, True),  # chip_smoke.py's configuration
    ("full_500kx100k_steady", 0.004, False),
    ("full_1mx200k", 0.002, False),
    # the fleet: each package's own sidecar processes over gRPC
    ("fleet_smoke", 0.05, False),
    ("fleet_kill_owner", 0.05, False),
]


@pytest.mark.parametrize(
    "name,scale,pin", DIGEST_CASES,
    ids=[f"{n}-{s}{'-auction' if p else ''}" for n, s, p in DIGEST_CASES],
)
def test_digests_equal_the_jax_package(name, scale, pin):
    ref, port = _both(name, scale, pin_auction=pin)
    for key in ("digest", "final_state_digest", "bound_total", "events",
                "preempted_total", "sim", "injected_errors", "rpc_failures",
                "invariant_violations", "restarts", "restored_objects",
                "agent_restored_jobs", "vnode_deletions"):
        assert port.determinism[key] == ref.determinism[key], key
    assert port.determinism_json() == ref.determinism_json()
    # the scorecard, but for the fast path's latencies (wall-clock ms)
    assert _virtual(port.quality) == _virtual(ref.quality)


#: (scenario, scale, pin the auction, what the JAX package's run gave):
#: its native-routed headlines (auto routing on the CPU sends every solve
#: to the native packer) and chip_smoke.py's phase [8] configuration at
#: scale 0.1, which the card ran before it ran the scenario uncut. Each
#: takes minutes on the CPU. Where each pin comes from is beside it.
HEADLINE_PINS = [
    # diagnostics/sim_full_50kx10k_r08.json (BASELINE.md, PR-4)
    ("full_50kx10k", 1.0, False, dict(
        digest="392a9fedf3a3b713dfbccdcf9c8f06f2f320485670d4ff1ddfc511f3f311d12c",
        bound_total=45_561)),
    # BASELINE.md's full_500kx100k pin (sharding on, 16 shards)
    ("full_500kx100k", 1.0, False, dict(
        final_state_digest="75110f56e42e5a05d89ac7e68b8a1bd0587ccab6b4af0a8aae7f5e002b9bf800",
        bound_total=457_006)),
    # JAX_PLATFORMS=cpu python -m slurm_bridge_tpu.sim full_1mx200k
    # (BASELINE.md keeps 02ba68b5… and 912,884 bound)
    ("full_1mx200k", 1.0, False, dict(
        final_state_digest="02ba68b584d47b00667a617e7f18fe246e7b70a2bd5825cfd41792068758bbfe",
        bound_total=912_884)),
    # JAX_PLATFORMS=cpu python tools/port_reference.py --sim full_500kx100k
    # --scale 0.1
    ("full_500kx100k", 0.1, True, dict(
        digest="b9beb7e6a1e442bb0b948998535007d5c3ffd2cb57e6794b94ef2eb862adf406",
        final_state_digest="d750a68037aff5a807e69858cbbb4136e22641139bf27b7cece536cbab157c61",
        bound_total=46_216)),
]


@pytest.mark.slow
@pytest.mark.parametrize(
    "name,scale,pin,want", HEADLINE_PINS,
    ids=[f"{n}-{s}{'-auction' if p else ''}" for n, s, p, _ in HEADLINE_PINS],
)
def test_headline_equals_the_jax_packages_pinned_digest(monkeypatch, name, scale, pin, want):
    """The port on the host backend (``SBT_BACKEND=cpu``, no device asked
    for: the scenario's own routing) gives the digests the JAX package
    pinned for the same run."""
    monkeypatch.setenv("SBT_BACKEND", "cpu")
    sc = port_scenarios.SCENARIOS[name](scale=scale)
    if pin:
        sc = _single_device_shards(_pinned_auction(sc, port_auction))
    d = port_sim.run_scenario(sc).determinism
    assert d["invariant_violations"] == []
    assert {k: d[k] for k in want} == want


def _virtual(quality: dict) -> dict:
    """The scorecard without wall-clock latencies and without the fleet's
    transport counters (remote solves against inline fallbacks follow the
    OS's scheduling of real sidecar processes; the harness keeps them out
    of the digests for that reason)."""
    return {
        k: v for k, v in quality.items()
        if "latency" not in k and k != "fleet_remote"
    }


# ---- the JAX package's pinned baselines ---------------------------------


def _fixture_cases():
    """(fixture, scenario, arm) the way the JAX package's tests run them:
    the ``*_off`` arm replaces the named field, ``on`` runs the default."""
    arms = {
        "coldec_off_baseline": [("coldec", False), ("on", None)],
        "frames_off_baseline": [("mirror_frames", False)],
        "incremental_off_baseline": [("incremental", False), ("on", None)],
        "policy_off_baseline": [("on", None)],
        "admission_off_baseline": [("admission", None)],
        "shard_off_baseline": [("on", None)],
    }
    #: the JAX package's tests run coldec "on" for these two only
    coldec_on = {"burst_backlog", "steady_poisson"}
    out = []
    for fixture, fixture_arms in arms.items():
        base = json.loads((FIXTURES / f"{fixture}.json").read_text())
        for name in sorted(base):
            for arm in fixture_arms:
                if fixture == "coldec_off_baseline" and arm[0] == "on" \
                        and name not in coldec_on:
                    continue
                out.append((fixture, name, arm))
    return out


FIXTURE_CASES = _fixture_cases()


@pytest.mark.parametrize(
    "fixture,name,arm", FIXTURE_CASES,
    ids=[f"{f.removesuffix('_off_baseline')}-{n}-{a[0]}" for f, n, a in FIXTURE_CASES],
)
def test_port_reproduces_off_baseline(fixture, name, arm):
    want = json.loads((FIXTURES / f"{fixture}.json").read_text())[name]
    sc = port_scenarios.SCENARIOS[name](scale=want["scale"], seed=want["seed"])
    field, value = arm
    if field != "on":
        sc = dataclasses.replace(sc, **{field: value})
    d = port_sim.run_scenario(sc, device="cpu").determinism
    assert d["digest"] == want["digest"]
    assert d["final_state_digest"] == want["final_state_digest"]
    got, exp = dict(d["events"]), dict(want["events"])
    if sc.incremental and fixture in (
        "incremental_off_baseline", "policy_off_baseline", "shard_off_baseline",
    ):
        # the incremental tick emits PlacementFailed once per backlog
        # generation: at most the fixture's per-tick count, and some
        got_pf, want_pf = got.pop("PlacementFailed", 0), exp.pop("PlacementFailed", 0)
        assert (0 < got_pf <= want_pf) if want_pf else got_pf == 0
    assert got == exp
    for key in ("bound_total", "preempted_total"):
        if key in want:
            assert d[key] == want[key], key


def test_every_fixture_entry_is_reproduced_or_waits():
    """Each entry of the six fixtures is one of the cases above, the
    sharded and crash entries included."""
    for fixture in ("coldec", "frames", "incremental", "policy", "admission", "shard"):
        base = json.loads((FIXTURES / f"{fixture}_off_baseline.json").read_text())
        covered = {n for f, n, _ in FIXTURE_CASES if f == f"{fixture}_off_baseline"}
        assert set(base) == covered


# ---- what waits, and the card -------------------------------------------


def test_waiting_scenarios_are_the_ones_listed():
    """No scenario waits: every one of them is a digest twin above."""
    assert {n for n, _, _ in DIGEST_CASES} == set(port_scenarios.SCENARIOS)


def test_fleet_scenarios_solve_remotely_and_leave_no_sidecar():
    """The fleet scenarios really solve through the port's sidecars (a
    silently-inline run would give the same digests), and every sidecar
    process is gone when the run ends."""
    h = port_harness.SimHarness(port_scenarios.fleet_smoke(scale=0.05), device="cpu")
    fleet = h.fleet
    pids = [s.proc.pid for s in fleet.supervisors.values()]
    result = h.run()
    assert result.quality["fleet_remote"]["remote_solves"] > 0
    assert result.determinism["fleet"]["replicas"] == 1
    assert h.fleet is None
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.delenv("SBT_BACKEND", raising=False)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    sc = port_scenarios.steady_poisson(scale=0.02)
    with pytest.raises(BackendUnavailable):
        port_sim.run_scenario(sc)
    with pytest.raises(BackendUnavailable):
        port_harness.SimHarness(sc)
    monkeypatch.setenv("SBT_BACKEND", "cpu")
    assert port_sim.run_scenario(dataclasses.replace(sc, ticks=2)).determinism["digest"]


def test_sim_rpc_error_is_the_ports_rpc_error():
    err = port_sim.SimRpcError(StatusCode.NOT_FOUND, "nope")
    assert isinstance(err, RpcError)
    assert err.code() == StatusCode.NOT_FOUND
    assert err.details() == "nope"
    assert str(err) == "NOT_FOUND: nope"


def test_cli_runs_a_scenario_on_the_cpu():
    """``python -m slurm_bridge_tpu_torch.sim`` as a user runs it, with
    the digest the JAX package's run gives."""
    env = dict(os.environ, SBT_BACKEND="cpu", PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "slurm_bridge_tpu_torch.sim", "steady_poisson",
         "--scale", "0.05", "--ticks", "4"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    got = json.loads([ln for ln in out.stdout.splitlines() if ln.startswith("{")][0])
    ref = jax_sim.run_scenario(
        dataclasses.replace(jax_scenarios.steady_poisson(scale=0.05), ticks=4)
    )
    assert got["determinism"]["digest"] == ref.determinism["digest"]
    listed = subprocess.run(
        [sys.executable, "-m", "slurm_bridge_tpu_torch.sim", "--list"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )
    assert listed.returncode == 0, listed.stderr
    assert "fleet_smoke: " in listed.stdout and "fleet_kill_owner: " in listed.stdout
    assert "crash_restart: " in listed.stdout and "sharded_smoke: " in listed.stdout
    assert "[not ported]" not in listed.stdout
    assert "full_50kx10k [slow]:" in listed.stdout


# ---- the forked pool ----------------------------------------------------


@pytest.fixture(scope="module")
def pool_arms():
    """burst_backlog run four ways — the JAX package, and the port with
    its pool disabled, forced to two workers, and forced to two workers
    killed before the run (the broken-pool inline fallback) — with the
    port's offload counters across the forced run."""
    prior = os.environ.get("SBT_COLPOOL_WORKERS")
    sc = port_scenarios.burst_backlog(scale=0.12)
    try:
        os.environ["SBT_COLPOOL_WORKERS"] = "0"
        ref = jax_sim.run_scenario(jax_scenarios.burst_backlog(scale=0.12))
        port_colpool.reset()
        serial = port_sim.run_scenario(sc, device="cpu")
        os.environ["SBT_COLPOOL_WORKERS"] = "2"
        port_colpool.reset()
        sub0 = port_vnode._submit_pool_chunks.total()
        row0 = port_operator._sweep_pool_rows.total()
        pooled = port_sim.run_scenario(sc, device="cpu")
        counters = (
            port_vnode._submit_pool_chunks.total() - sub0,
            port_operator._sweep_pool_rows.total() - row0,
        )
        port_colpool.reset()
        p = port_colpool.active_pool()
        assert p is not None and p._ensure()
        for proc in p._procs:
            proc.terminate()
        for proc in p._procs:
            proc.join(timeout=5.0)
        broken = port_sim.run_scenario(sc, device="cpu")
    finally:
        port_colpool.reset()
        if prior is None:
            os.environ.pop("SBT_COLPOOL_WORKERS", None)
        else:
            os.environ["SBT_COLPOOL_WORKERS"] = prior
    return ref, serial, pooled, broken, counters


@pytest.mark.parametrize("arm", ["serial", "pooled", "broken"])
def test_pool_is_digest_neutral(pool_arms, arm):
    ref, serial, pooled, broken, _ = pool_arms
    run = {"serial": serial, "pooled": pooled, "broken": broken}[arm]
    assert run.determinism["digest"] == ref.determinism["digest"]
    assert run.determinism["final_state_digest"] == ref.determinism["final_state_digest"]
    assert run.determinism["invariant_violations"] == []


def test_pool_work_left_the_main_thread(pool_arms):
    submit_chunks, sweep_rows = pool_arms[-1]
    assert submit_chunks > 0 and sweep_rows > 0


def test_raising_run_reaps_both_pools(monkeypatch):
    """A run that dies mid-tick still joins its forked workers."""
    monkeypatch.setenv("SBT_COLPOOL_WORKERS", "2")
    procs = []
    for colpool, harness, scenarios, kw in (
        (port_colpool, port_harness, port_scenarios, {"device": "cpu"}),
        (jax_colpool, jax_harness, jax_scenarios, {}),
    ):
        colpool.reset()
        p = colpool.active_pool()
        assert p is not None and p._ensure()
        procs += list(p._procs)
        h = harness.SimHarness(scenarios.steady_poisson(scale=0.05), **kw)
        monkeypatch.setattr(
            h, "run_tick",
            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("mid-tick")),
        )
        with pytest.raises(RuntimeError, match="mid-tick"):
            h.run()
        assert colpool._pool is None
    for pr in procs:
        pr.join(timeout=5.0)
    assert not any(pr.is_alive() for pr in procs)


_ORPHAN = """
import os, sys
os.environ["SBT_COLPOOL_WORKERS"] = "2"
from slurm_bridge_tpu_torch.parallel import colpool
p = colpool.active_pool()
assert p._ensure()
print(" ".join(str(pr.pid) for pr in p._procs), flush=True)
os.kill(os.getpid(), 9)
"""


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split()[2] != "Z"
    except FileNotFoundError:
        return False


def test_pool_workers_exit_when_their_parent_dies_unreaped():
    """A parent killed before it can reap its pool leaves no worker
    behind: each worker sees EOF on its pipe and exits (a worker that
    kept the parent's pipe ends open would wait in recv() forever,
    holding every descriptor it inherited)."""
    out = subprocess.run(
        [sys.executable, "-c", _ORPHAN], capture_output=True, text=True,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=120,
    )
    assert out.returncode == -signal.SIGKILL
    pids = [int(x) for x in out.stdout.split()]
    assert len(pids) == 2
    deadline = time.monotonic() + 10.0
    while any(_alive(pid) for pid in pids) and time.monotonic() < deadline:
        time.sleep(0.05)
    alive = [pid for pid in pids if _alive(pid)]
    for pid in alive:
        os.kill(pid, signal.SIGKILL)
    assert alive == []
