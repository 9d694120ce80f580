"""The port's streaming reschedule against the JAX package's, tick for tick.

The same churn run — ``churn_scenario`` at a small size, one converging
tick, then churn ticks drawn from ``np.random.default_rng(0)`` — goes
through both packages with the device engine and the dense auction
pinned (the port on the CPU). Every tick's ``node_of``, kept, preempted
and started shards are equal, no tolerance; ``free_after`` is equal too.
The incumbent pin, the no-preemption boost, the ``bucket`` padding and the
session rebuild on a config change are held the same way, and so is the
sharded route: the multi-device sweep on eight CPU blocks against the JAX
package's on its eight virtual devices.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import slurm_bridge_tpu.solver.auction as jax_auction
import slurm_bridge_tpu.solver.streaming as jax_streaming
import slurm_bridge_tpu_torch.parallel.mesh as port_mesh
import slurm_bridge_tpu_torch.solver.auction as port_auction
import slurm_bridge_tpu_torch.solver.streaming as port_streaming
from chip_smoke import CHURN, churn_summary, churn_tick

SMALL = dict(CHURN, num_nodes=500, num_jobs=2000)


def _dense(auction):
    return auction.AuctionConfig(rounds=8, candidates=0, use_pallas=False)


def _sims(**shape):
    jax_sim = jax_streaming.churn_scenario(**dict(SMALL, **shape))
    port_sim = port_streaming.churn_scenario(**dict(SMALL, **shape), device="cpu")
    for sim, auction in ((jax_sim, jax_auction), (port_sim, port_auction)):
        sim.config = _dense(auction)
        sim.engine = "device"
    return jax_sim, port_sim


def _equal(got, want):
    assert churn_summary(got) == churn_summary(want)
    for key in ("incumbent", "kept", "preempted", "started"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), key)
    np.testing.assert_array_equal(got.placement.placed, want.placement.placed)
    np.testing.assert_array_equal(got.placement.free_after, want.placement.free_after)


def test_churn_run_equals_the_jax_package():
    """One converging tick and three churn ticks of 50 jobs, tick for
    tick: most rows of each churn tick are pinned incumbents."""
    jax_sim, port_sim = _sims()
    jax_rng, port_rng = np.random.default_rng(0), np.random.default_rng(0)
    pinned = []
    for i in range(4):
        want = _churn(jax_sim, jax_streaming, jax_rng, i)
        got = _churn(port_sim, port_streaming, port_rng, i)
        _equal(got, want)
        np.testing.assert_array_equal(port_sim.assign, jax_sim.assign)
        pinned.append(float(got.incumbent.mean()))
        assert port_sim.last_engine == "device"
    assert pinned[0] == 0.0 and min(pinned[1:]) > 0.5


def _churn(sim, streaming, rng, i):
    if i == 0:
        return churn_tick(sim, streaming.churn_step, rng, 0)
    return streaming.churn_step(sim, rng, 50)


@pytest.mark.parametrize("preemption", [True, False])
def test_streaming_place_with_incumbents_equals_the_jax_package(preemption):
    """A re-solve where every placed shard of a first solve is pinned to
    its node, with and without preemption (the incumbents' priority
    boost), through ``streaming_place`` without a session."""
    snap, batch = port_streaming.random_scenario(400, 1500, seed=9, load=0.9)
    first = port_auction.auction_place(snap, batch, _dense(port_auction), device="cpu")
    inc = np.where(first.placed, first.node_of, -1).astype(np.int32)
    # the shards left out contend with the incumbents at a higher priority
    batch = dataclasses.replace(
        batch, priority=np.where(inc < 0, batch.priority + 50, batch.priority).astype(np.float32)
    )
    want = jax_streaming.streaming_place(
        snap, batch, inc, _dense(jax_auction), preemption=preemption
    )
    got = port_streaming.streaming_place(
        snap, batch, inc, _dense(port_auction), preemption=preemption, device="cpu"
    )
    _equal(got, want)
    # an incumbent either keeps exactly its node or is preempted: no migration
    moved = got.incumbent & got.placement.placed & (got.placement.node_of != inc)
    assert not moved.any()
    if not preemption:
        # boosted ahead of every newcomer, each incumbent re-admits into
        # the capacity it fit in before
        assert not got.preempted.any()


@pytest.mark.parametrize("bucket", [0, 256, 4096])
def test_bucket_padding_equals_the_jax_package(bucket):
    snap, batch = port_streaming.random_scenario(300, 900, seed=4)
    inc = np.full(batch.num_shards, -1, np.int32)
    inc[::3] = np.arange(0, batch.num_shards, 3) % snap.num_nodes
    want = jax_streaming.streaming_place(snap, batch, inc, _dense(jax_auction), bucket=bucket)
    got = port_streaming.streaming_place(
        snap, batch, inc, _dense(port_auction), bucket=bucket, device="cpu"
    )
    _equal(got, want)
    assert got.placement.node_of.shape == (batch.num_shards,)


def test_session_is_rebuilt_when_the_config_changes():
    _, sim = _sims(num_nodes=200, num_jobs=600)
    sim.tick()
    first = sim._session
    sim.tick()
    assert sim._session is first  # same config: the staged snapshot stays
    sim.config = port_auction.AuctionConfig(rounds=3, candidates=0, use_pallas=False)
    sim.tick()
    assert sim._session is not first and sim._session.config.rounds == 3
    assert sim._session.device.type == "cpu"


def test_auto_engine_on_the_cpu_backend_is_native_like_the_jax_package():
    """``engine="auto"`` routes by the port's ``choose_path``: the CPU
    backend sends every tick to the native packer, as the JAX package's
    rule does on its CPU backend."""
    jax_sim, port_sim = _sims(num_nodes=200, num_jobs=600)
    jax_sim.engine = port_sim.engine = "auto"
    _equal(port_sim.tick(), jax_sim.tick())
    assert port_sim.last_engine == "native"


def test_sharded_route_is_not_ported(monkeypatch):
    """``sharded=True`` solves on the multi-device sweep over the process's
    devices — eight CPU blocks here, the JAX package's eight virtual
    devices there — pins included, equal tick for tick."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(port_mesh, "process_devices", lambda backend: [cpu] * 8)
    snap, batch = port_streaming.random_scenario(50, 100, seed=1)
    first = port_auction.auction_place(snap, batch, _dense(port_auction), device="cpu")
    inc = np.where(first.placed, first.node_of, -1).astype(np.int32)
    want = jax_streaming.streaming_place(snap, batch, inc, _dense(jax_auction), sharded=True)
    got = port_streaming.streaming_place(snap, batch, inc, _dense(port_auction),
                                         sharded=True, device="cpu")
    _equal(got, want)
    assert got.kept.any()
    jax_sim, port_sim = _sims(num_nodes=50, num_jobs=100)
    jax_sim.sharded = port_sim.sharded = True
    jax_rng, port_rng = np.random.default_rng(0), np.random.default_rng(0)
    for i in range(2):
        _equal(_churn(port_sim, port_streaming, port_rng, i),
               _churn(jax_sim, jax_streaming, jax_rng, i))
        assert port_sim.last_engine == "sharded" and port_sim._session is None


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    from slurm_bridge_tpu_torch.parallel.backend import BackendUnavailable

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    monkeypatch.delenv("SBT_BACKEND", raising=False)
    sim = port_streaming.churn_scenario(50, 100, seed=1)
    sim.engine = "device"
    with pytest.raises(BackendUnavailable):
        sim.tick()
