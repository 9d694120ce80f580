"""ctypes binding for the indexed native packer (solver/native/indexed.cpp).

Same contract and placement semantics as :func:`greedy_native.greedy_place_native`
(bit-identical results — asserted by tests/test_solver.py), but
O((P+N)·log N) via per-(partition, feature) ordered buckets instead of the
baseline's O(P·N) scan. This is the CPU fast path the scheduler and bench
route to when no accelerator is available or the solve is below the device
dispatch floor (solver/routing.py); greedy.cpp stays untouched as the
measured baseline.

Degradation chain if indexed.cpp won't build: the native greedy baseline
(same placements, ~20× slower at the headline shape), which itself falls
back to the pure-Python oracle when no toolchain exists at all.
"""

from __future__ import annotations

import logging
import pathlib

from slurm_bridge_tpu_torch import BUILD_DIR
from slurm_bridge_tpu_torch.solver.nativelib import (
    NativeBuildError,
    call_place,
    load_symbol,
    place_argtypes,
)
from slurm_bridge_tpu_torch.solver.snapshot import ClusterSnapshot, JobBatch, Placement

log = logging.getLogger("sbt.solver")

_SRC = pathlib.Path(__file__).parent / "native" / "indexed.cpp"
_LIB = BUILD_DIR / "libsbtindexed.so"

_build_failed = False


def indexed_place_native(
    snapshot: ClusterSnapshot,
    batch: JobBatch,
    *,
    best_fit: bool = True,
    incumbent=None,
    policy: str | None = None,
) -> Placement:
    """Drop-in replacement for :func:`greedy.greedy_place`, index-accelerated.

    All three fit policies ride a treap: best-fit (the default) and
    worst-fit on a (free_cpu, index) key with subtree maxima of the other
    dims (worst-fit is the mirrored rightmost query), first-fit on the
    node-index key with ALL dims augmented plus a cpu-keyed feasibility
    twin. Worst-fit is the routed pin-free policy: the measured quality
    winner at every BASELINE shape (45,239 jobs vs best-fit's 44,928 at
    the 50k×10k headline) at best-fit speed (BASELINE.md round 5).

    ``incumbent`` ([P] int32, -1 = free agent) pins streaming incumbents to
    their held nodes (greedy.py semantics) — the CPU-fast engine for
    incumbent-bearing ticks (VERDICT r4 #1). greedy.cpp is the measured
    baseline and stays pin-free, so a pinned solve that cannot use the
    indexed library degrades to the pure-Python oracle instead.
    """
    global _build_failed
    import numpy as np

    from slurm_bridge_tpu_torch.solver.greedy_native import greedy_place_native

    if policy is None:
        policy = "best" if best_fit else "first"
    mode = {"first": 0, "best": 1, "worst": 2}.get(policy)
    if mode is None:
        raise ValueError(f"unknown fit policy {policy!r}")
    pinned = incumbent is not None and bool((np.asarray(incumbent) >= 0).any())

    def _fallback() -> Placement:
        if pinned:
            # greedy.cpp (the measured baseline) knows nothing of pins —
            # pinned solves degrade to the pure-Python oracle (slow but
            # semantically exact; streaming ticks are the rare case here)
            from slurm_bridge_tpu_torch.solver.greedy import greedy_place

            return greedy_place(
                snapshot, batch, incumbent=incumbent, policy=policy
            )
        # pin-free worst-fit degrades to NATIVE best-fit, not the Python
        # oracle: availability first — the router sends 50k×10k solves
        # here, where the oracle takes minutes and the native packer tens
        # of ms at −0.7% quality
        return greedy_place_native(snapshot, batch, best_fit=policy != "first")

    # the treap index supports 1..4 resource dims; RESOURCE_DIMS ships 3 —
    # an exotic wider snapshot takes the baseline, which handles any arity
    if _build_failed or not 1 <= snapshot.free.shape[1] <= 4:
        return _fallback()
    try:
        fn = load_symbol(
            _SRC,
            _LIB,
            "sbt_indexed_place",
            place_argtypes(with_best_fit=True, with_pin=True),
        )
    except NativeBuildError as exc:
        # degrade, don't crash the tick: the native greedy places
        # identically (and has its own oracle fallback for no-toolchain)
        _build_failed = True
        log.warning("%s — falling back to the native greedy packer", exc)
        return _fallback()
    return call_place(
        fn,
        snapshot,
        batch,
        best_fit=mode,
        incumbent=incumbent if pinned else None,
        with_pin=True,
    )
