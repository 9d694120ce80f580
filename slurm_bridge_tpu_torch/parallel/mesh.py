"""The solver's ("dp", "mp") grid of blocks.

The solve's two big axes map onto a 2-D grid of devices:
- ``dp`` splits the *pods* axis (the pending work);
- ``mp`` splits the *nodes* axis.

Each grid entry is one block of the sweep (:mod:`..solver.sharded`): a
``torch.device`` that scores a [P/dp, N/mp] block every round. Several
entries may name one device: a 2×2 grid of ``cuda:0`` blocks runs the
sweep's block path on one card, as eight CPU blocks run it on the host.

With a process group up (:mod:`distributed`), the "dp" rows span the
ranks in rank order and "mp" stays inside one process: a rank scores only
its own rows, and the per-round gather over "dp" crosses the group.

Replaces ``slurm_bridge_tpu/parallel/mesh.py`` (a ``jax.sharding.Mesh``);
:func:`solver_mesh`'s factor rule and errors and :func:`pad_to_multiple`
are the reference's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True, eq=False)
class SolverMesh:
    """A dp×mp grid of blocks.

    ``devices`` is a [dp, mp] object array: ``devices[i, j]`` is the device
    of block (dp=i, mp=j) in the process that owns row ``i``; ``ranks[i]``
    is that process's rank (0 for every row without a group). ``group`` is
    the process group the "dp" gather crosses, or None for a
    single-process grid."""

    devices: np.ndarray
    ranks: tuple[int, ...]
    group: object | None = None

    axis_names = ("dp", "mp")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def local_rows(self, rank: int) -> list[int]:
        """The dp rows ``rank`` scores."""
        return [i for i, r in enumerate(self.ranks) if r == rank]


def process_devices(backend: str) -> list[torch.device]:
    """The devices this process solves on for ``backend``: every CUDA
    device it sees (the one a rank of an NCCL group is bound to), or one
    CPU device. The sweep's mesh and every auto route count these."""
    if backend == "cpu":
        return [torch.device("cpu")]
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_backend() == "nccl":
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_count(backend: str) -> int:
    """The devices the default mesh spans: this process's
    :func:`process_devices` on ``backend`` times the ranks of the group
    (the reference's ``len(jax.devices())``). Every auto route asks it."""
    return len(process_devices(backend)) * _world()[0]


def _factor(n: int, dp: int | None, mp: int | None, local: int | None = None) -> tuple[int, int]:
    """The reference's rule: square-ish, the larger factor on "dp". With
    ``local`` (the devices of one process, when the grid spans ranks) the
    default "mp" also divides it, so no block row crosses a process."""
    if dp is None and mp is None:
        mp = 1
        for f in range(int(math.isqrt(n)), 0, -1):
            if n % f == 0 and (local or n) % f == 0:
                mp = f
                break
        dp = n // mp
    elif dp is None:
        if n % mp:
            raise ValueError(f"mp={mp} does not divide {n} devices")
        dp = n // mp
    elif mp is None:
        if n % dp:
            raise ValueError(f"dp={dp} does not divide {n} devices")
        mp = n // dp
    if dp * mp != n:
        raise ValueError(f"dp×mp = {dp}×{mp} != {n} devices")
    return dp, mp


def _grid(devs: list, ranks: list[int], dp: int, mp: int, group) -> SolverMesh:
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    row_ranks = []
    for i in range(dp):
        owners = set(ranks[i * mp:(i + 1) * mp])
        if len(owners) != 1:
            raise ValueError(
                f"mp={mp} crosses a process boundary: the mp axis must stay "
                "inside one process (its combine runs every round)"
            )
        row_ranks.append(owners.pop())
    return SolverMesh(grid.reshape(dp, mp), tuple(row_ranks), group)


def solver_mesh(
    devices: list | None = None,
    *,
    dp: int | None = None,
    mp: int | None = None,
    backend: str | None = None,
) -> SolverMesh:
    """Build a ("dp", "mp") grid over the given devices (default: this
    process's :func:`process_devices` on ``backend`` — None asks
    :func:`..backend.ensure_backend` — across every rank when a process
    group is up).

    Without explicit factors, devices are split as square as possible with
    the larger factor on "dp" (the pods axis usually dwarfs the nodes axis).
    Across ranks the default "mp" is held to a divisor of each process's
    devices (one card per NCCL rank gives mp=1), where the reference's
    mesh may let "mp" span processes; explicit factors that make it do so
    raise.
    """
    group, local = None, None
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        ranks = [0] * len(devs)
    else:
        from slurm_bridge_tpu_torch.parallel.backend import ensure_backend

        mine = process_devices(backend or ensure_backend())
        world, group = _world()
        devs = mine * world
        ranks = [r for r in range(world) for _ in mine]
        local = len(mine)
    dp, mp = _factor(len(devs), dp, mp, local)
    return _grid(devs, ranks, dp, mp, group)


def _world() -> tuple[int, object | None]:
    """(ranks, group): the default process group when one is up with more
    than one rank, else (1, None)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.get_world_size(), dist.group.WORLD
    return 1, None


def pad_to_multiple(x: np.ndarray, multiple: int, *, axis: int = 0, value=0):
    """Pad ``x`` along ``axis`` to the next multiple; returns (padded, orig_len)."""
    size = x.shape[axis]
    target = ((size + multiple - 1) // multiple) * multiple if size else multiple
    if target == size:
        return x, size
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, target - size)
    return np.pad(x, pad_width, constant_values=value), size
