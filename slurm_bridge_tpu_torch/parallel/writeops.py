"""Write-side column ops for the colpool workers (ISSUE 18).

PR 15/16 made the cold tick's *read* side parallel (worker-pool
decode+diff); what remained single-threaded were the two write loops the
roadmap names: the submit fan-out's per-request proto encode and the
operator sweep's per-owner demand/label build. Both are pure functions
of immutable inputs, so they ship to the forked colpool workers the same
way the decode op does — raw little-endian column frames in, raw frames
out, no object graph crossing a pipe in either direction.

Two ops live here (dispatched by :mod:`~slurm_bridge_tpu_torch.parallel.colpool`):

``_OP_ENCODE_SUBMIT``
    parent packs effective (demand, submitter) rows into one frame per
    submit chunk (:func:`pack_submit_frame`); the worker emits the
    serialized ``SubmitJobsRequest`` wire bytes for the chunk
    (:func:`encode_submit_frame`) — byte-identical to pb2
    ``SerializeToString`` by way of
    :func:`~slurm_bridge_tpu_torch.wire.convert.encode_submit_entry`, so the
    agent sees exactly the bytes the serial arm would have sent.

``_OP_BUILD_ROWS``
    parent packs sizecar-create spec columns
    (:func:`pack_build_chunk`); the worker runs the #SBATCH header
    parse + spec-override resolution of ``operator.demand_for_spec``
    and returns the resolved demand scalars plus the request-cpu /
    request-memory-mb label strings (:func:`build_rows_frame` /
    :func:`unpack_build_result`). The parent keeps everything with
    side effects — ``frozen_new`` demand construction, uid draws, the
    locked ``create_rows`` scatter — so store commit order stays
    byte-identical to the serial sweep.

Dependency-light on purpose: core + wire only, no bridge imports — the
workers fork from whatever the parent has loaded, and this module must
be importable inside them without dragging the store/controller stack.
"""

from __future__ import annotations

import struct
from functools import lru_cache

import numpy as np

from slurm_bridge_tpu_torch.core.arrays import array_len
from slurm_bridge_tpu_torch.core.sbatch import extract_batch_resources
from slurm_bridge_tpu_torch.wire.convert import _T_REQUESTS, encode_submit_entry
from slurm_bridge_tpu_torch.wire.coldec import uvarint

__all__ = [
    "pack_submit_frame",
    "encode_submit_frame",
    "pack_build_chunk",
    "build_rows_frame",
    "unpack_build_result",
]

_Q = struct.Struct("<q")

#: JobDemand fields shipped as int64 columns in a submit frame, in frame
#: order (run_as_user/run_as_group are ``or 0``-normalized on pack, the
#: same coalescing :func:`~slurm_bridge_tpu_torch.wire.convert.fill_submit_request`
#: applies)
_SUBMIT_I64 = (
    "run_as_user", "run_as_group", "cpus_per_task", "ntasks",
    "ntasks_per_node", "nodes", "mem_per_cpu_mb", "time_limit_s",
    "priority",
)
#: JobDemand string fields shipped as packed str columns, frame order
_SUBMIT_STR = (
    "script", "partition", "array", "job_name", "working_dir",
    "gres", "licenses",
)

#: BridgeJobSpec fields a build frame ships (the sweep's inputs to
#: ``demand_for_spec``); resolution against the #SBATCH header happens
#: in the worker
_BUILD_STR = ("sbatch_script", "partition", "array", "working_dir", "gres")
_BUILD_I64 = ("cpus_per_task", "ntasks", "ntasks_per_node", "nodes", "mem_per_cpu_mb")

#: resolved columns a build result frame carries back, frame order
_BUILT_STR = ("partition", "array", "working_dir", "gres", "request_cpu", "request_mem")
_BUILT_I64 = (
    "cpus_per_task", "ntasks", "ntasks_per_node", "nodes",
    "mem_per_cpu_mb", "time_limit_s",
)


# ---- frame primitives --------------------------------------------------


def _pack_scol(vals: list[str]) -> bytes:
    """One str column: payload length, int64 per-row lengths, utf8 payload."""
    bs = [s.encode("utf-8") for s in vals]
    lens = np.fromiter(map(len, bs), np.int64, len(bs))
    payload = b"".join(bs)
    return _Q.pack(len(payload)) + lens.tobytes() + payload


def _unpack_scol(buf, off: int, n: int) -> tuple[list[str], int]:
    (plen,) = _Q.unpack_from(buf, off)
    off += 8
    lens = np.frombuffer(buf, np.int64, n, off)
    off += n * 8
    payload = bytes(buf[off : off + plen])
    out = []
    pos = 0
    for ln in lens.tolist():
        out.append(payload[pos : pos + ln].decode("utf-8"))
        pos += ln
    return out, off + plen


def _pack_icol(vals, n: int) -> bytes:
    return np.fromiter(vals, np.int64, n).tobytes()


def _unpack_icol(buf, off: int, n: int) -> tuple[list[int], int]:
    return np.frombuffer(buf, np.int64, n, off).tolist(), off + n * 8


# ---- _OP_ENCODE_SUBMIT -------------------------------------------------


def pack_submit_frame(rows: list[tuple]) -> bytes:
    """Effective submit rows → one request frame. ``rows`` are
    ``(demand, submitter_id)`` pairs AFTER the converge pass's filtering
    and hint substitution (``vnode._submit_rows``) — the frame carries
    exactly what the wire request will say, nothing derived remains."""
    n = len(rows)
    dems = [r[0] for r in rows]
    parts = [_Q.pack(n)]
    parts.append(_pack_scol([r[1] for r in rows]))
    for name in _SUBMIT_STR:
        parts.append(_pack_scol([getattr(d, name) for d in dems]))
    for name in _SUBMIT_I64:
        parts.append(_pack_icol(
            ((getattr(d, name) or 0) for d in dems), n))
    counts = [len(d.nodelist) for d in dems]
    parts.append(_pack_icol(counts, n))
    flat = [h for d in dems for h in d.nodelist]
    parts.append(_Q.pack(len(flat)))
    parts.append(_pack_scol(flat))
    return b"".join(parts)


def encode_submit_frame(buf) -> bytes:
    """Worker side of ``_OP_ENCODE_SUBMIT``: unpack one submit frame and
    emit the chunk's serialized ``SubmitJobsRequest`` — the request-order
    concatenation of length-delimited field-1 entries, each built by the
    fuzz-pinned :func:`encode_submit_entry`."""
    (n,) = _Q.unpack_from(buf, 0)
    off = 8
    submitter, off = _unpack_scol(buf, off, n)
    scols = {}
    for name in _SUBMIT_STR:
        scols[name], off = _unpack_scol(buf, off, n)
    icols = {}
    for name in _SUBMIT_I64:
        icols[name], off = _unpack_icol(buf, off, n)
    counts, off = _unpack_icol(buf, off, n)
    (total,) = _Q.unpack_from(buf, off)
    off += 8
    flat, off = _unpack_scol(buf, off, total)
    out = []
    pos = 0
    for i in range(n):
        c = counts[i]
        body = encode_submit_entry(
            scols["script"][i],
            scols["partition"][i],
            submitter[i],
            icols["run_as_user"][i],
            icols["run_as_group"][i],
            icols["cpus_per_task"][i],
            icols["ntasks"][i],
            icols["ntasks_per_node"][i],
            icols["nodes"][i],
            icols["mem_per_cpu_mb"][i],
            scols["array"][i],
            scols["job_name"][i],
            scols["working_dir"][i],
            scols["gres"][i],
            scols["licenses"][i],
            icols["time_limit_s"][i],
            icols["priority"][i],
            flat[pos : pos + c],
        )
        pos += c
        out += (_T_REQUESTS, uvarint(len(body)), body)
    return b"".join(out)


# ---- _OP_BUILD_ROWS ----------------------------------------------------


@lru_cache(maxsize=512)
def _parsed_header(script: str):
    """The worker's own memo of ``operator._parsed_header`` — same
    source function, same cache shape, but a per-process cache: a forked
    worker cannot see the parent's lru entries, and the storm's handful
    of distinct script bodies makes both hit-dominated."""
    return extract_batch_resources(script).demand


def pack_build_chunk(creates: list[tuple]) -> bytes:
    """One sizecar-create chunk → a request frame. ``creates`` are the
    sweep's captured ``(owner, spec, job labels)`` triples; only the
    spec columns the demand resolution reads ride the wire — owner,
    labels and the residual spec fields (run_as_user, licenses,
    priority, …) stay with the parent, which re-attaches them when it
    rebuilds the frozen demand."""
    n = len(creates)
    specs = [s for _o, s, _l in creates]
    parts = [_Q.pack(n)]
    for name in _BUILD_STR:
        parts.append(_pack_scol([getattr(s, name) for s in specs]))
    for name in _BUILD_I64:
        parts.append(_pack_icol(
            ((getattr(s, name) or 0) for s in specs), n))
    return b"".join(parts)


def build_rows_frame(buf) -> bytes:
    """Worker side of ``_OP_BUILD_ROWS``: run ``demand_for_spec``'s
    header-parse + override chain per row and return the resolved
    scalars, plus the request-cpu / request-memory-mb label strings
    (``JobDemand.total_cpus`` / ``total_mem_mb`` over the resolved array
    length — pod.go:143-187's sizing rule). Field-for-field equality
    with the serial ``demand_for_spec`` is fuzz-pinned."""
    (n,) = _Q.unpack_from(buf, 0)
    off = 8
    scols = {}
    for name in _BUILD_STR:
        scols[name], off = _unpack_scol(buf, off, n)
    icols = {}
    for name in _BUILD_I64:
        icols[name], off = _unpack_icol(buf, off, n)
    out: dict[str, list] = {name: [] for name in _BUILT_STR}
    iout: dict[str, list] = {name: [] for name in _BUILT_I64}
    for i in range(n):
        hdr = _parsed_header(scols["sbatch_script"][i])
        partition = scols["partition"][i] or hdr.partition
        array = scols["array"][i] or hdr.array
        cpus_per_task = icols["cpus_per_task"][i] or hdr.cpus_per_task or 1
        ntasks = icols["ntasks"][i] or hdr.ntasks or 1
        ntasks_per_node = icols["ntasks_per_node"][i] or hdr.ntasks_per_node
        nodes = icols["nodes"][i] or hdr.nodes or 1
        working_dir = scols["working_dir"][i] or hdr.working_dir
        mem_per_cpu_mb = icols["mem_per_cpu_mb"][i] or hdr.mem_per_cpu_mb or 1024
        gres = scols["gres"][i] or hdr.gres
        arr = array_len(array)
        total_cpus = max(1, cpus_per_task) * max(1, ntasks) * max(1, arr)
        out["partition"].append(partition)
        out["array"].append(array)
        out["working_dir"].append(working_dir)
        out["gres"].append(gres)
        out["request_cpu"].append(str(total_cpus))
        out["request_mem"].append(str(mem_per_cpu_mb * total_cpus))
        iout["cpus_per_task"].append(cpus_per_task)
        iout["ntasks"].append(ntasks)
        iout["ntasks_per_node"].append(ntasks_per_node)
        iout["nodes"].append(nodes)
        iout["mem_per_cpu_mb"].append(mem_per_cpu_mb)
        iout["time_limit_s"].append(hdr.time_limit_s)
    parts = [_Q.pack(n)]
    for name in _BUILT_STR:
        parts.append(_pack_scol(out[name]))
    for name in _BUILT_I64:
        parts.append(_pack_icol(iout[name], n))
    return b"".join(parts)


def unpack_build_result(buf) -> dict[str, list]:
    """Parent side of ``_OP_BUILD_ROWS``: one result frame → resolved
    columns (plain Python lists — str and int, ready for ``frozen_new``)."""
    (n,) = _Q.unpack_from(buf, 0)
    off = 8
    cols: dict[str, list] = {}
    for name in _BUILT_STR:
        cols[name], off = _unpack_scol(buf, off, n)
    for name in _BUILT_I64:
        cols[name], off = _unpack_icol(buf, off, n)
    return cols
