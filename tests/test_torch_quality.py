"""The policy tick with preemption: the port's placement-quality arms
against the JAX package's, with the engine pinned as chip_smoke.py phase
[15] pins it on the card.

(a) Every arm chip_smoke.py runs (:data:`chip_smoke.QUALITY_CELLS`:
    ``priority_inversion`` on, policy off and with the full tick;
    ``multi_tenant_storm`` on and policy off; ``diurnal_load`` on, policy
    off and backfill off; ``elastic_resize`` on) and phase [14]'s
    admission-off twin of ``interactive_storm``, at ``sim/cli.py``'s
    ``SMOKE_SCALE``: the same arm (:func:`chip_smoke.arm_scenario`) with
    the auction pinned (the dense plain path here; ``diurnal_load`` on its
    own 2-round auction with ``candidates=0``) gives the JAX package's
    digests, bound, preempted count, events and scorecard.
(b) ``priority_inversion``'s full tick equals its incremental tick, and
    :func:`chip_smoke.quality_gates` reads the arms as ``_quality`` does.
(c) The port's ``sim.cli.main(["--quality"])`` and ``["--admission"]``
    return and print what the JAX package's do.
(d) ``tools/port_reference.py --sim NAME --arm ARM`` keeps a scenario's
    own auction, pinning only ``candidates=0``.

No tolerance: every compared value is exact.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import pathlib

import pytest
import torch

import slurm_bridge_tpu.parallel.colpool as jax_colpool
import slurm_bridge_tpu.policy.engine as jax_engine
import slurm_bridge_tpu.sim.cli as jax_cli
import slurm_bridge_tpu.sim.harness as jax_harness
import slurm_bridge_tpu.sim.scenarios as jax_scenarios
import slurm_bridge_tpu_torch.parallel.colpool as port_colpool
import slurm_bridge_tpu_torch.policy.engine as port_engine
import slurm_bridge_tpu_torch.sim.cli as port_cli
import slurm_bridge_tpu_torch.sim.harness as port_harness
import slurm_bridge_tpu_torch.sim.scenarios as port_scenarios
from chip_smoke import (
    QUALITY_CELLS,
    arm_record,
    arm_scenario,
    pin_auction,
    quality_gates,
    virtual_scorecard,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
SCALE = port_cli.SMOKE_SCALE


def _load_port_reference():
    spec = importlib.util.spec_from_file_location("port_reference",
                                                  REPO / "tools" / "port_reference.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


port_reference = _load_port_reference()
#: (scenario, arm): phase [15]'s arms and phase [14]'s admission-off twin
ARM_CASES = [(name, arm) for name, cell in QUALITY_CELLS.items() for arm in cell["arms"]] + [
    ("interactive_storm", "admission_off")
]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs in parallel workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _reap_pools(monkeypatch):
    """Two forked pool workers per run, and neither package's pool
    outlives a test."""
    monkeypatch.setenv("SBT_COLPOOL_WORKERS", "2")
    yield
    port_colpool.reset()
    jax_colpool.reset()


@functools.lru_cache(maxsize=None)
def _ref(name: str, arm: str) -> dict:
    """The JAX package's run of one arm at :data:`SCALE`, pinned as the
    card's references are (``tools/port_reference.py --sim --arm``)."""
    return port_reference.run_sim(name, SCALE, arm)


@functools.lru_cache(maxsize=None)
def _port(name: str, arm: str):
    """The port's run of the same arm, pinned as chip_smoke.py pins it."""
    sc = arm_scenario(port_scenarios.SCENARIOS[name](scale=SCALE), arm, port_engine.PolicyConfig)
    return port_harness.SimHarness(pin_auction(sc), device="cpu").run()


@pytest.mark.parametrize("name,arm", ARM_CASES, ids=[f"{n}-{a}" for n, a in ARM_CASES])
def test_arm_equals_the_jax_package(name, arm):
    ref, port = _ref(name, arm), _port(name, arm)
    cfg = port.scenario.auction_config
    assert f"rounds={cfg.rounds}" in ref["config"] and cfg.candidates == 0
    got = arm_record(port)
    assert got == {k: ref[k] for k in got}
    assert port.determinism["invariant_violations"] == [] and ref["invariant_violations"] == 0


def test_the_policy_arm_preempts_by_class():
    """With the class table on, the production gang preempts batch
    incumbents of higher numeric priority, in both packages alike; at this
    scale numeric-priority preemption (policy off) displaces no one."""
    got = {arm: [_port("priority_inversion", arm).determinism["preempted_total"],
                 _ref("priority_inversion", arm)["preempted_total"]] for arm in ("on", "policy_off")}
    assert got["on"][0] >= 1 and got["on"][0] == got["on"][1]
    assert got["policy_off"] == [0, 0]


def test_full_tick_equals_the_incremental_tick():
    inc, full = _port("priority_inversion", "on"), _port("priority_inversion", "full_tick")
    assert not full.scenario.incremental and inc.scenario.incremental
    for key in ("digest", "final_state_digest", "preempted_total"):
        assert full.determinism[key] == inc.determinism[key], key
    assert virtual_scorecard(full.quality) == virtual_scorecard(inc.quality)


@pytest.mark.parametrize("name", list(QUALITY_CELLS))
def test_gates_read_the_arms_as_the_cli_does(name):
    """At ``SMOKE_SCALE`` the JAX package's ``_quality`` holds every gate
    (test_cli_gates_equal_the_jax_packages), so :func:`quality_gates` must
    find each holding on the port's arms and on the JAX package's."""
    max_rec = port_scenarios.SCENARIOS[name](scale=SCALE).max_recovery_ticks
    arms = QUALITY_CELLS[name]["arms"]
    for package, summaries in (
            ("port", {a: arm_record(_port(name, a))["quality"] for a in arms}),
            ("jax", {a: _ref(name, a)["quality"] for a in arms})):
        gates = quality_gates(name, summaries, port_cli.QUALITY_GATES, max_rec)
        assert gates, name
        assert [g for g in gates if not g[1]] == [], package


def _cli_lines(main, flag, capsys) -> tuple[int, list[dict], list[str]]:
    rc = main([flag])
    out, err = capsys.readouterr()
    lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    for line in lines:  # wall-clock latencies differ from run to run
        for key in [k for k in line if "latency" in k]:
            line.pop(key)
    verdict = [line for line in err.splitlines() if line.startswith("# ")]
    return rc, lines, verdict


@pytest.mark.parametrize("flag", ["--quality", "--admission"])
def test_cli_gates_equal_the_jax_packages(flag, capsys, monkeypatch):
    monkeypatch.setenv("SBT_BACKEND", "cpu")  # the port's scenarios route by backend
    ref = _cli_lines(jax_cli.main, flag, capsys)
    port = _cli_lines(port_cli.main, flag, capsys)
    assert ref[0] == 0
    assert port == ref


@pytest.mark.parametrize("arm", QUALITY_CELLS["diurnal_load"]["arms"])
def test_port_reference_keeps_a_scenarios_own_auction(arm):
    """``--sim diurnal_load --arm ARM`` runs the scenario's own 2-round
    auction without repair, only ``candidates=0`` pinned: its digests are
    ``run_scenario``'s of that scenario with ``candidates=0``."""
    got = _ref("diurnal_load", arm)
    sc = arm_scenario(jax_scenarios.diurnal_load(scale=SCALE), arm, jax_engine.PolicyConfig)
    own = sc.auction_config
    assert (own.rounds, own.repair, own.gang_salvage_rounds) == (2, False, 1)
    want = arm_record(jax_harness.run_scenario(dataclasses.replace(
        sc, auction_config=dataclasses.replace(own, candidates=0))))
    assert "rounds=2" in got["config"] and "repair=False" in got["config"]
    assert {k: got[k] for k in want} == want
