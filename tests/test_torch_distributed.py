"""The port's multi-process bootstrap and process-spanning meshes.

``slurm_process_env`` is held to the JAX package's on the same
environment; ``init_distributed`` resolves its rendezvous (explicit args,
torch's environment, the Slurm step's) and its backend without starting a
group; and two OS processes joined over gloo run the sweep with two CPU
blocks each — the counterpart of ``tests/test_distributed.py``'s
``jax.distributed`` run — and must give the single-process grid's
placement on both ranks.
"""

import hashlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import slurm_bridge_tpu.parallel.distributed as jax_dist
import slurm_bridge_tpu.solver.sharded as jsh
import slurm_bridge_tpu_torch.parallel.distributed as dist
import slurm_bridge_tpu_torch.parallel.mesh as port_mesh
import slurm_bridge_tpu_torch.solver.sharded as tsh
from slurm_bridge_tpu.parallel.mesh import solver_mesh as jax_mesh
from slurm_bridge_tpu.solver.auction import AuctionConfig as JaxConfig
from slurm_bridge_tpu.solver.snapshot import random_scenario as jax_scenario
from slurm_bridge_tpu_torch.solver.auction import AuctionConfig
from slurm_bridge_tpu_torch.solver.snapshot import random_scenario

CPU = torch.device("cpu")
REPO = pathlib.Path(__file__).resolve().parents[1]

#: environments a Slurm step (or none) gives its tasks
SLURM_ENVS = [
    dict(SLURM_PROCID="3", SLURM_NTASKS="8", SLURM_STEP_NODELIST="tpu[001-004]"),
    dict(SLURM_PROCID="0", SLURM_NTASKS="2", SLURM_JOB_NODELIST="gpu-a,gpu-b",
         SBT_COORDINATOR_PORT="9000"),
    dict(SLURM_PROCID="1", SLURM_NTASKS="4", SLURM_STEP_NODELIST="n[7,9-10]"),
    dict(SLURM_PROCID="1", SLURM_NTASKS="4"),  # no node list
    dict(SLURM_NTASKS="4", SLURM_STEP_NODELIST="n1"),  # no rank
    dict(),
]
_ENV_KEYS = ("SLURM_PROCID", "SLURM_NTASKS", "SLURM_STEP_NODELIST",
             "SLURM_JOB_NODELIST", "SBT_COORDINATOR_PORT")


@pytest.fixture
def clean_env(monkeypatch):
    for key in (*_ENV_KEYS, "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK", "SLURM_LOCALID", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(dist, "_initialized", False)
    return monkeypatch


@pytest.mark.parametrize("env", SLURM_ENVS)
def test_slurm_process_env_equals_the_jax_package(clean_env, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    assert dist.slurm_process_env() == jax_dist.slurm_process_env()


def test_init_single_process_noop(clean_env):
    assert dist.init_distributed() is False
    assert dist.init_distributed() is False  # idempotent


@pytest.fixture
def joins(clean_env):
    """``torch.distributed.init_process_group`` recorded, not run."""
    calls = []
    clean_env.setattr(torch.distributed, "init_process_group",
                      lambda backend, **kw: calls.append(dict(kw, backend=backend)))
    clean_env.setenv("SBT_BACKEND", "cpu")
    return calls


@pytest.mark.parametrize("source,env,args,want", [
    ("explicit", {}, ("10.0.0.1:7000", 2, 1), ("tcp://10.0.0.1:7000", 2, 1)),
    ("torch", dict(MASTER_ADDR="h0", MASTER_PORT="29500", WORLD_SIZE="4", RANK="2"),
     (), ("env://", 4, 2)),
    ("slurm", dict(SLURM_PROCID="1", SLURM_NTASKS="2", SLURM_STEP_NODELIST="gpu[3-4]"),
     (), ("tcp://gpu3:8476", 2, 1)),
    # explicit args win over the environment, torch's over Slurm's
    ("explicit-over-env", dict(MASTER_ADDR="h0", MASTER_PORT="1", WORLD_SIZE="9"),
     ("h1:2", 3, 0), ("tcp://h1:2", 3, 0)),
    ("torch-over-slurm", dict(MASTER_ADDR="h0", MASTER_PORT="5", WORLD_SIZE="2", RANK="1",
                              SLURM_PROCID="0", SLURM_NTASKS="8", SLURM_STEP_NODELIST="x1"),
     (), ("env://", 2, 1)),
])
def test_init_resolution_order(joins, monkeypatch, source, env, args, want):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dist.init_distributed(*args) is True
    init_method, world, rank = want
    assert joins == [dict(backend="gloo", init_method=init_method, world_size=world,
                          rank=rank)]
    dist.init_distributed(*args)  # idempotent: no second join
    assert len(joins) == 1


def test_init_backend_is_the_callers_or_the_device_family(joins, monkeypatch):
    """NCCL for ranks on the card (each binding its local rank's card),
    gloo on the CPU or when asked; never a switch on its own."""
    import slurm_bridge_tpu_torch.parallel.backend as backend

    monkeypatch.setattr(backend, "ensure_backend", lambda device=None: "cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    bound = []
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    monkeypatch.setenv("LOCAL_RANK", "5")
    assert dist.init_distributed("h:1", 8, 5)
    assert joins[-1]["backend"] == "nccl" and bound == [1]
    monkeypatch.setattr(dist, "_initialized", False)
    assert dist.init_distributed("h:1", 2, 1, backend="gloo")
    assert joins[-1]["backend"] == "gloo" and bound == [1]
    monkeypatch.setattr(dist, "_initialized", False)
    with pytest.raises(ValueError):
        dist.init_distributed("h:1", 2, 1, backend="mpi")


def test_hybrid_mesh_single_process(clean_env):
    clean_env.setattr(port_mesh, "process_devices", lambda backend: [CPU] * 8)
    clean_env.setenv("SBT_BACKEND", "cpu")
    mesh = dist.hybrid_solver_mesh()
    assert mesh.axis_names == ("dp", "mp")
    assert mesh.devices.size == len(jax.devices()) == 8
    assert mesh.shape == port_mesh.solver_mesh().shape == dict(jax_mesh().shape)
    assert mesh.group is None and set(mesh.ranks) == {0}
    assert dist.hybrid_solver_mesh(mp_per_slice=2, devices=[CPU] * 4).shape == {"dp": 2, "mp": 2}


def test_hybrid_mesh_keeps_mp_inside_a_process(clean_env):
    """With two ranks of two blocks each: "dp" spans the ranks in rank
    order, and an mp wider than a process's blocks is refused."""
    group = object()
    clean_env.setattr(port_mesh, "_world", lambda: (2, group))
    mesh = dist.hybrid_solver_mesh(devices=[CPU, CPU])
    assert mesh.shape == {"dp": 2, "mp": 2} and mesh.ranks == (0, 1)
    assert mesh.group is group and mesh.local_rows(1) == [1]
    assert dist.hybrid_solver_mesh(mp_per_slice=1, devices=[CPU, CPU]).ranks == (0, 0, 1, 1)
    with pytest.raises(ValueError, match="exceeds 2 local devices"):
        dist.hybrid_solver_mesh(mp_per_slice=4, devices=[CPU, CPU])
    with pytest.raises(ValueError):
        dist.hybrid_solver_mesh(mp_per_slice=2, devices=[CPU] * 3)  # a row across ranks


@pytest.mark.parametrize("world,local,want", [
    (4, 1, {"dp": 4, "mp": 1}),  # one card per NCCL rank: mp stays 1
    (9, 1, {"dp": 9, "mp": 1}),
    (2, 4, {"dp": 4, "mp": 2}),
    (3, 3, {"dp": 3, "mp": 3}),
    (2, 3, {"dp": 6, "mp": 1}),  # square-ish 3x2 would split a process's row
])
def test_default_mesh_across_ranks_keeps_mp_inside_a_process(clean_env, world, local, want):
    """With a group up, the default mesh (every caller's ``mesh=None``)
    spans ``world`` ranks of ``local`` blocks: "mp" divides the blocks of
    one process, and the auto routes count every rank's devices."""
    group = object()
    clean_env.setattr(port_mesh, "_world", lambda: (world, group))
    clean_env.setattr(port_mesh, "process_devices", lambda backend: [CPU] * local)
    mesh = port_mesh.solver_mesh(backend="cpu")
    assert mesh.shape == want and mesh.group is group
    assert sorted(mesh.ranks) == list(mesh.ranks) and set(mesh.ranks) == set(range(world))
    assert port_mesh.device_count("cpu") == world * local
    if local == 1:
        across = next(f for f in range(2, world + 1) if world % f == 0)
        with pytest.raises(ValueError, match="crosses a process boundary"):
            port_mesh.solver_mesh(backend="cpu", mp=across)


#: the gloo runs' scenario and config (tests/test_distributed.py's)
SCENARIO = dict(num_nodes=64, num_jobs=200, seed=7, load=0.6, gang_fraction=0.1)
ROUNDS = 4


def _digest(node_of: np.ndarray) -> str:
    return hashlib.sha256(node_of.astype("<i4").tobytes()).hexdigest()


#: the gloo runs: (ranks, each rank's CPU blocks, dp, mp, the mesh the
#: workers build). "hybrid" is tests/test_distributed.py's two processes
#: of two blocks; "default" is four ranks of one block each (one card per
#: NCCL rank), solved with ``mesh=None`` as every caller's sharded route
#: does, so the default mesh must keep "mp" inside a process
GLOO_RUNS = {
    "hybrid-2x2": (2, 2, 2, 2, "hybrid"),
    "default-4x1": (4, 1, 4, 1, "default"),
}


@pytest.mark.parametrize("run", list(GLOO_RUNS))
def test_two_process_gloo_sweep_matches_one_process(tmp_path, run):
    """OS processes joined over gloo into one dp×mp grid: the per-round
    "dp" gather crosses the process boundary, and every rank must compute
    the placement of the single-process grid of that shape — which is the
    JAX package's on the same grid."""
    ranks, local, dp, mp, build = GLOO_RUNS[run]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(textwrap.dedent(f"""
        import hashlib, json, sys
        sys.path.insert(0, {str(REPO)!r})
        import torch
        torch.set_num_threads(1)
        import slurm_bridge_tpu_torch.parallel.mesh as port_mesh
        from slurm_bridge_tpu_torch.parallel.distributed import (
            hybrid_solver_mesh, init_distributed)
        from slurm_bridge_tpu_torch.solver.auction import AuctionConfig
        from slurm_bridge_tpu_torch.solver.sharded import sharded_place
        from slurm_bridge_tpu_torch.solver.snapshot import random_scenario
        rank = int(sys.argv[1])
        assert init_distributed("127.0.0.1:{port}", {ranks}, rank, backend="gloo")
        cpu = torch.device("cpu")
        mesh = (hybrid_solver_mesh(devices=[cpu] * {local}) if {build!r} == "hybrid"
                else port_mesh.solver_mesh(backend="cpu"))
        snap, batch = random_scenario(**{SCENARIO!r})
        pl = sharded_place(snap, batch, AuctionConfig(rounds={ROUNDS}),
                           mesh=mesh if {build!r} == "hybrid" else None, device="cpu")
        print(json.dumps({{
            "rank": rank, "shape": mesh.shape, "rows": mesh.local_rows(rank),
            "world": torch.distributed.get_world_size(),
            "backend": torch.distributed.get_backend(),
            "count": port_mesh.device_count("cpu"),
            "placed": int(pl.placed.sum()),
            "digest": hashlib.sha256(pl.node_of.astype("<i4").tobytes()).hexdigest(),
        }}), flush=True)
        # every rank past its last collective before any tears down
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    """))
    procs = [
        subprocess.Popen([sys.executable, str(worker), str(rank)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                         env=dict(os.environ, SBT_BACKEND="cpu"))
        for rank in range(ranks)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        # a failed or hung rank must not keep its peers waiting on the group
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [o["rank"] for o in outs] == list(range(ranks))
    assert all(o["shape"] == {"dp": dp, "mp": mp} and o["world"] == ranks
               and o["backend"] == "gloo" and o["count"] == ranks for o in outs), outs
    rows = dp // ranks
    assert [o["rows"] for o in outs] == [list(range(r * rows, (r + 1) * rows))
                                         for r in range(ranks)]
    assert outs[0]["placed"] > 0
    assert len({o["digest"] for o in outs}) == 1, outs

    snap, batch = random_scenario(**SCENARIO)
    one = tsh.sharded_place(snap, batch, AuctionConfig(rounds=ROUNDS),
                            mesh=port_mesh.solver_mesh([CPU] * (dp * mp), dp=dp, mp=mp),
                            device="cpu")
    assert outs[0]["digest"] == _digest(one.node_of)
    want = jsh.sharded_place(*jax_scenario(**SCENARIO), JaxConfig(rounds=ROUNDS, use_pallas=False),
                             mesh=jax_mesh(jax.devices()[:dp * mp], dp=dp, mp=mp))
    assert outs[0]["digest"] == _digest(want.node_of)
