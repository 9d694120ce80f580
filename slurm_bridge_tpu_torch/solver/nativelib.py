"""Shared ctypes loader for the native solver libraries.

Both native packers (greedy.cpp — the measured baseline — and indexed.cpp —
the CPU fast path) are plain C-ABI shared objects compiled on first use
with g++ -O3 into the package's build directory (:data:`BUILD_DIR`, never
next to the sources); a rebuild happens whenever the source is newer than
the binary. One loader serves both so build flags, rebuild logic, and
error surfacing cannot drift apart.

No pybind11 (environment constraint) — plain ctypes. A host without a
C++ toolchain raises :class:`NativeBuildError` with the compiler's stderr;
callers degrade to the pure-Python oracle rather than crashing the
scheduler tick.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

from slurm_bridge_tpu_torch import BUILD_DIR

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    """g++ missing or the compile failed; message carries the stderr."""


def _build(src: pathlib.Path, lib: pathlib.Path) -> None:
    # Compile to a process-unique temp path and os.replace() it in: the
    # per-process lock below cannot stop a SECOND process (bridge + sidecar
    # share a host) from dlopening a half-written .so mid-compile, and
    # runtime builds are the norm now that no binary is checked in
    # (ADVICE r4). rename(2) is atomic on one filesystem, so a concurrent
    # loader sees either the old complete library or the new complete one.
    # sweep orphans first: a process killed mid-compile (OOM, pod
    # eviction) leaves its pid-unique temp behind forever otherwise.
    # Age-gated so a live concurrent builder's in-flight temp survives.
    import time

    lib.parent.mkdir(parents=True, exist_ok=True)
    for stale in lib.parent.glob(f".{lib.name}.*.tmp"):
        try:
            if time.time() - stale.stat().st_mtime > 600:
                stale.unlink()
        except OSError:
            pass  # racing builder finished/cleaned it first
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-shared",
        "-fPIC",
        "-std=c++17",
        str(src),
        "-o",
        str(tmp),
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:  # g++ not on PATH
        raise NativeBuildError(
            f"cannot build {lib.name}: g++ unavailable ({exc})"
        ) from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"g++ failed building {lib.name} (rc={proc.returncode}):\n"
            f"{proc.stderr.strip()}"
        )
    try:
        os.replace(tmp, lib)
    except OSError as exc:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"cannot install {lib.name}: {exc}") from exc


def load_symbol(
    src: pathlib.Path,
    lib: pathlib.Path,
    symbol: str,
    argtypes: list,
    restype=ctypes.c_int,
):
    """Return the bound function ``symbol`` from ``lib``, building it from
    ``src`` first when missing or stale. Thread-safe; cached per path."""
    key = str(lib)
    with _lock:
        cdll = _loaded.get(key)
        if cdll is None:
            if not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime:
                _build(src, lib)
            try:
                cdll = ctypes.CDLL(key)
            except OSError as exc:
                # a corrupt/truncated cached .so (e.g. left by a crashed
                # build before installs were atomic) must degrade like a
                # failed build, not crash the scheduler tick (ADVICE r4)
                raise NativeBuildError(f"cannot load {lib.name}: {exc}") from exc
            _loaded[key] = cdll
    fn = getattr(cdll, symbol)
    fn.restype = restype
    fn.argtypes = argtypes
    return fn


def ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def place_argtypes(*, with_best_fit: bool, with_pin: bool = False) -> list:
    """The shared C ABI of both packers. greedy.cpp takes the best_fit
    flag (0/1) before the output pointer; indexed.cpp takes BOTH the
    fit-policy selector (0 = first, 1 = best, 2 = worst, same slot) AND a
    nullable incumbent-pin array after it."""
    argtypes = [
        ctypes.c_int,  # n
        ctypes.c_int,  # r
        ctypes.POINTER(ctypes.c_float),  # free_io
        ctypes.POINTER(ctypes.c_int32),  # node_part
        ctypes.POINTER(ctypes.c_uint32),  # node_feat
        ctypes.c_int,  # p
        ctypes.POINTER(ctypes.c_float),  # dem
        ctypes.POINTER(ctypes.c_int32),  # job_part
        ctypes.POINTER(ctypes.c_uint32),  # req_feat
        ctypes.POINTER(ctypes.c_float),  # prio
        ctypes.POINTER(ctypes.c_int32),  # gang
    ]
    if with_best_fit:
        argtypes.append(ctypes.c_int)
    if with_pin:
        argtypes.append(ctypes.POINTER(ctypes.c_int32))  # pin (nullable)
    argtypes.append(ctypes.POINTER(ctypes.c_int32))  # out_assign
    return argtypes


def call_place(
    fn,
    snapshot,
    batch,
    *,
    best_fit: bool | None = None,
    incumbent=None,
    with_pin: bool = False,
):
    """Marshal a (snapshot, batch) pair into the shared packer ABI, call
    ``fn``, and lift the result back into a Placement.

    ``best_fit=None`` omits the flag argument (for indexed.cpp); both
    bindings share this marshalling so the array contract cannot drift.
    ``with_pin`` appends the incumbent array (NULL when ``incumbent`` is
    None — the no-incumbent fast call).
    """
    import numpy as np

    from slurm_bridge_tpu_torch.solver.auction import normalize_gangs
    from slurm_bridge_tpu_torch.solver.snapshot import Placement

    n, r = snapshot.free.shape
    p = batch.num_shards
    free_io = np.ascontiguousarray(snapshot.free, dtype=np.float32).copy()
    assign = np.full(p, -1, dtype=np.int32)
    # gang ids index a p-sized table in C++ — remap arbitrary ids into [0, p)
    gang = np.ascontiguousarray(normalize_gangs(batch.gang_id), dtype=np.int32)
    args = [
        n,
        r,
        ptr(free_io, ctypes.c_float),
        ptr(np.ascontiguousarray(snapshot.partition_of, np.int32), ctypes.c_int32),
        ptr(np.ascontiguousarray(snapshot.features, np.uint32), ctypes.c_uint32),
        p,
        ptr(np.ascontiguousarray(batch.demand, np.float32), ctypes.c_float),
        ptr(np.ascontiguousarray(batch.partition_of, np.int32), ctypes.c_int32),
        ptr(np.ascontiguousarray(batch.req_features, np.uint32), ctypes.c_uint32),
        ptr(np.ascontiguousarray(batch.priority, np.float32), ctypes.c_float),
        ptr(gang, ctypes.c_int32),
    ]
    if best_fit is not None:
        # fit-policy selector, not a strict bool: 1 = best-fit, 0 =
        # first-fit, 2 = worst-fit (indexed.cpp; greedy.cpp knows 0/1)
        args.append(int(best_fit))
    if with_pin:
        if incumbent is None:
            args.append(None)
        else:
            args.append(
                ptr(np.ascontiguousarray(incumbent, np.int32), ctypes.c_int32)
            )
    args.append(ptr(assign, ctypes.c_int32))
    rc = fn(*args)
    if rc < 0:
        raise ValueError(
            "native packer rejected its inputs (gang id or incumbent pin "
            "out of range)"
        )
    return Placement(node_of=assign, placed=assign >= 0, free_after=free_io)
