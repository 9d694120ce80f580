"""ctypes binding for the native greedy packer (solver/native/greedy.cpp).

This is the measured baseline the ≥10× target is defined against
(BASELINE.md) — semantics bit-identical to the Python oracle
:func:`greedy.greedy_place`, asserted by the test suite. Built on first
use via the shared loader (:mod:`nativelib`); a host without a C++
toolchain falls back to the oracle (identical placements, just slow).
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

_SRC = pathlib.Path(__file__).parent / "native" / "greedy.cpp"
_LIB = BUILD_DIR / "libsbtgreedy.so"

_build_failed = False


def greedy_place_native(
    snapshot: ClusterSnapshot,
    batch: JobBatch,
    *,
    best_fit: bool = True,
) -> Placement:
    """Drop-in replacement for :func:`greedy.greedy_place`, ~100× faster."""
    global _build_failed
    if _build_failed:
        from slurm_bridge_tpu_torch.solver.greedy import greedy_place

        return greedy_place(snapshot, batch, best_fit=best_fit)
    try:
        fn = load_symbol(
            _SRC, _LIB, "sbt_greedy_place", place_argtypes(with_best_fit=True)
        )
    except NativeBuildError as exc:
        _build_failed = True
        log.warning("%s — falling back to the pure-Python packer", exc)
        from slurm_bridge_tpu_torch.solver.greedy import greedy_place

        return greedy_place(snapshot, batch, best_fit=best_fit)
    return call_place(fn, snapshot, batch, best_fit=best_fit)
