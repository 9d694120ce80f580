"""Backend- and size-aware solver routing — pick the adequate engine.

Two placement engines with different cost envelopes:

- the **indexed native packer** (:mod:`indexed_native`): single-core C++,
  greedy-parity quality, O((P+N)·log N), no device dispatch at all;
- the **device auction** (:mod:`session` / :mod:`auction`): PyTorch on the
  card with the hand-written ``bid_argmax`` kernel doing score/choose;
  every solve pays a device dispatch and a device→host copy.

Routing rule (the same rules as the JAX package, keyed by the torch
backend name): any solve when no card is in use (``"cpu"``), any gang- or
incumbent-dominated batch, and any solve below the dispatch floor goes to
the indexed native packer; everything else goes to the device auction.
The thresholds are the reference's; they have not been re-measured on the
card yet.
"""

from __future__ import annotations

import os

import numpy as np

#: Below this many P×N cells the device dispatch is assumed to dominate
#: the solve. 2^25 ≈ 33.5M cells puts the 57,635 × 10,000 headline solve
#: (576M cells) on the device. Override: SBT_ROUTE_FLOOR_CELLS.
DISPATCH_FLOOR_CELLS = 1 << 25


def floor_cells() -> int:
    raw = os.environ.get("SBT_ROUTE_FLOOR_CELLS", "")
    if not raw:
        return DISPATCH_FLOOR_CELLS
    try:
        val = int(raw)
    except ValueError as exc:
        raise ValueError(
            f"SBT_ROUTE_FLOOR_CELLS={raw!r} is not an integer"
        ) from exc
    if val < 0:
        raise ValueError(f"SBT_ROUTE_FLOOR_CELLS={raw!r} must be >= 0")
    return val


#: Fit policy for pin-free solves routed to the indexed native packer:
#: worst-fit (max free cpu) spreads load and preserves multi-dim balance
#: where min-cpu packing strands memory. Pinned (streaming) ticks stay on
#: best-fit — the tier-2 preemption machinery is defined for that policy.
NATIVE_FIT_DEFAULT = "worst"


def native_fit_policy(has_pins: bool = False) -> str:
    """The fit policy the routed native engine should use."""
    if has_pins:
        return "best"
    pol = os.environ.get("SBT_NATIVE_FIT", "") or NATIVE_FIT_DEFAULT
    if pol not in ("best", "first", "worst"):
        raise ValueError(f"SBT_NATIVE_FIT={pol!r}: want best|first|worst")
    return pol


#: Above this share of multi-node-gang shards the sequential packer is the
#: right algorithm: the auction's jitter spread fragments the cluster for
#: many-node gangs structurally.
GANG_DOMINANCE = 0.5


def gang_shard_fraction(gang_id) -> float:
    """Share of shards belonging to multi-shard gangs. O(P) host work."""
    gang_id = np.asarray(gang_id)
    if gang_id.size == 0:
        return 0.0
    from slurm_bridge_tpu_torch.solver.auction import normalize_gangs

    norm = normalize_gangs(gang_id)
    counts = np.bincount(norm)
    return float((counts[norm] > 1).mean())


#: Above this share of incumbent-pinned shards a tick is steady-state
#: rescheduling, where the packer's reserve-first pins keep placements
#: still and the auction would re-fight contention every tick.
INCUMBENT_DOMINANCE = 0.5


def incumbent_fraction(incumbent) -> float:
    """Share of shards pinned to a node they already hold. O(P) host work."""
    inc = np.asarray(incumbent)
    if inc.size == 0:
        return 0.0
    return float((inc >= 0).mean())


#: Below this many P×N cells a multi-device sweep can't amortise its
#: collectives — the sharded auto-select floor (scheduler and sidecar
#: share this one rule so the two deployment modes route identically).
SHARDED_FLOOR_CELLS = 1 << 20


def use_sharded(
    num_shards: int,
    num_nodes: int,
    n_devices: int,
    threshold: int = SHARDED_FLOOR_CELLS,
) -> bool:
    """Whether the device solve should run the multi-device sweep."""
    return n_devices >= 2 and num_shards * num_nodes >= threshold


def choose_path(
    num_shards: int,
    num_nodes: int,
    *,
    backend_name: str | None = None,
    gang_fraction: float = 0.0,
    inc_fraction: float = 0.0,
) -> str:
    """Return ``"native"`` or ``"device"`` for a solve of this shape.

    ``backend_name`` is the torch backend (``"cuda"`` or ``"cpu"``);
    ``None`` asks :func:`~slurm_bridge_tpu_torch.parallel.backend.ensure_backend`,
    which raises when no card is present and the CPU was not asked for.
    ``gang_fraction`` (:func:`gang_shard_fraction`) and ``inc_fraction``
    (:func:`incumbent_fraction`) route dominated batches native regardless
    of size.
    """
    if backend_name is None:
        from slurm_bridge_tpu_torch.parallel.backend import ensure_backend

        backend_name = ensure_backend()
    if backend_name == "cpu":
        return "native"
    if gang_fraction > GANG_DOMINANCE:
        return "native"
    if inc_fraction > INCUMBENT_DOMINANCE:
        return "native"
    return "device" if num_shards * num_nodes >= floor_cells() else "native"
