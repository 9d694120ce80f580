"""Multi-process bootstrap and process-spanning meshes for the solver.

The bridge keeps gRPC for control traffic; the sweep's per-round data
plane (:mod:`..solver.sharded`) rides ``torch.distributed``. This module is
the bootstrap seam:

- :func:`init_distributed` joins a process group from explicit arguments,
  torch's own rendezvous environment (``MASTER_ADDR``/``MASTER_PORT``/
  ``WORLD_SIZE``/``RANK``) or — fitting, for a framework whose job is
  Slurm — the Slurm step environment itself (SLURM_PROCID / SLURM_NTASKS /
  SLURM_STEP_NODELIST), the same variables ``srun`` exports for every task
  of a job the bridge submitted. NCCL joins CUDA ranks on distinct cards;
  gloo joins CPU ranks, and any ranks whose caller asks for it (two ranks
  on one card: NCCL refuses them). The backend never changes on its own.
- :func:`hybrid_solver_mesh` builds a ("dp", "mp") grid whose "mp" (nodes)
  axis stays inside one process and whose "dp" (pods) axis spans the
  ranks: the per-round "mp" combine moves O(P/dp × mp) values every round
  and stays local, while the "dp" gather is one O(P) vector per round.

Replaces ``slurm_bridge_tpu/parallel/distributed.py`` (``jax.distributed``);
:func:`slurm_process_env` is the reference's.
"""

from __future__ import annotations

import logging
import os

from slurm_bridge_tpu_torch.parallel import mesh as _mesh
from slurm_bridge_tpu_torch.parallel.mesh import SolverMesh

log = logging.getLogger("sbt.distributed")

_initialized = False


def slurm_process_env() -> dict | None:
    """Coordinator spec derived from a Slurm step's environment, or None.

    Uses the first host of SLURM_STEP_NODELIST as the coordinator — every
    task of the step sees the same value, which is all the rendezvous
    needs. Hostlist expressions are expanded with the same parser the agent
    uses for scontrol output.
    """
    if "SLURM_PROCID" not in os.environ or "SLURM_NTASKS" not in os.environ:
        return None
    nodelist = os.environ.get("SLURM_STEP_NODELIST") or os.environ.get(
        "SLURM_JOB_NODELIST", ""
    )
    if not nodelist:
        return None
    from slurm_bridge_tpu_torch.core.hostlist import expand_hostlist

    hosts = expand_hostlist(nodelist)
    port = int(os.environ.get("SBT_COORDINATOR_PORT", "8476"))
    return {
        "coordinator_address": f"{hosts[0]}:{port}",
        "num_processes": int(os.environ["SLURM_NTASKS"]),
        "process_id": int(os.environ["SLURM_PROCID"]),
    }


def _torch_env() -> dict | None:
    """torch's own rendezvous environment, or None when it is not set."""
    if not os.environ.get("MASTER_ADDR") or not os.environ.get("MASTER_PORT"):
        return None
    return {
        "coordinator_address": None,  # env:// reads it
        "num_processes": int(os.environ.get("WORLD_SIZE", "1")),
        "process_id": int(os.environ.get("RANK", "0")),
    }


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
) -> bool:
    """Join the process group once; returns True when multi-process.

    Resolution order: explicit args → torch's rendezvous env
    (``MASTER_ADDR`` et al.) → the Slurm step environment → single-process
    no-op. Safe to call repeatedly.

    ``backend`` is ``"nccl"`` or ``"gloo"``; None means NCCL when the solve
    runs on the card (:func:`..backend.ensure_backend`) and gloo on the
    CPU. An NCCL rank binds the card of its local
    rank (``LOCAL_RANK`` or ``SLURM_LOCALID``, else its rank) modulo the
    cards it sees.
    """
    global _initialized
    import torch
    import torch.distributed as dist

    if _initialized:
        return dist.is_initialized() and dist.get_world_size() > 1
    if coordinator_address is not None:
        spec = {
            "coordinator_address": coordinator_address,
            "num_processes": num_processes,
            "process_id": process_id,
        }
    else:
        spec = _torch_env() or slurm_process_env()
    if spec is None or (spec.get("num_processes") or 1) <= 1:
        _initialized = True
        return False
    if backend is None:
        from slurm_bridge_tpu_torch.parallel.backend import ensure_backend

        backend = "nccl" if ensure_backend() == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: want nccl|gloo")
    world, rank = int(spec["num_processes"]), int(spec["process_id"])
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("SLURM_LOCALID", rank)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    addr = spec["coordinator_address"]
    dist.init_process_group(
        backend,
        init_method=f"tcp://{addr}" if addr else "env://",
        world_size=world,
        rank=rank,
    )
    _initialized = True
    log.info("process group up (%s): rank %d/%d", backend, rank, world)
    return True


def hybrid_solver_mesh(
    *,
    mp_per_slice: int | None = None,
    devices: list | None = None,
) -> SolverMesh:
    """("dp", "mp") grid with "mp" confined to one process.

    ``devices`` are this process's blocks (default: its
    :func:`..mesh.process_devices` on the solve's backend); every rank
    brings as many. Keeping "mp" within them keeps the per-round
    node-block combine local. With one process this degrades to
    :func:`..mesh.solver_mesh`.
    """
    import torch

    if devices is None:
        from slurm_bridge_tpu_torch.parallel.backend import ensure_backend

        devices = _mesh.process_devices(ensure_backend())
    local = [torch.device(d) for d in devices]
    world, group = _mesh._world()
    if world <= 1:
        return _mesh.solver_mesh(local, mp=mp_per_slice)
    n_local = len(local)
    mp = mp_per_slice or n_local
    if mp > n_local:
        raise ValueError(
            f"mp_per_slice={mp} exceeds {n_local} local devices — the mp axis "
            "must not cross the process boundary (its combine is per-round bulk)"
        )
    total = n_local * world
    if total % mp:
        raise ValueError(f"mp={mp} does not divide {total} global devices")
    dp, mp = _mesh._factor(total, None, mp)
    ranks = [r for r in range(world) for _ in local]
    return _mesh._grid(local * world, ranks, dp, mp, group)
