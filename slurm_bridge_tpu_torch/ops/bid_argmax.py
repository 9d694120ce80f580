"""Fused masked bid + running argmax — the auction round's hot op.

One auction round must find, for every pending shard, the best feasible
node under the current prices:

    bid[p, n]  = jitter·hash(p, n, salt) + w·affinity[p, n] − price[n]
    ok[p, n]   = partition ∧ features ∧ capacity ∧ incumbent-pin
    choice[p]  = argmax_n where(ok, bid, −inf)

:func:`bid_argmax` computes it without anything [P, N]-shaped in device
memory: on a CUDA tensor it launches the hand-written Hopper kernel
``csrc/bid_argmax.cu``; on a CPU tensor it runs :func:`bid_argmax_plain`,
the same computation tile by tile in PyTorch ops. There is no fallback
between the two — a CUDA call launches the kernel or raises.

A ``live`` mask says which rows the caller still needs; the others return
the sentinel. The auction passes ``assign < 0``: placed rows' answers were
thrown away anyway.

Source note:

- Replaces the Pallas TPU kernel ``slurm_bridge_tpu/ops/bid_argmax.py:_kernel``
  (wrapper ``bid_argmax``), with the same inputs, outputs, sentinel
  (``choice == num_nodes`` where nothing is feasible), lowest-index tie
  rule and global ``p_base``/``n_base`` offsets.
- What bounds it on the card: integer issue on the cells the inputs need,
  not memory. The operands are O((P+N)·R) words; each needed cell costs
  the operations of :data:`CELL_OPS` (counted from the kernel's cell
  loop). A cell is needed when its row is live and the node lies in the
  row's partition (every node, for a row of any partition).
- What the design does about it: :func:`work_list` compacts the live rows
  (sorted by partition) on the device; each tile of :data:`TILE_ROWS` of
  them walks only the range of the partition-ordered node list
  (:func:`node_order`) its rows can take (:func:`tile_ranges`); a block
  scores one (row tile, 64-node chunk) work item, so the work
  spreads over the whole card, and each thread scores every staged node
  against the rows it holds in registers. Chunks merge through an
  order-independent 64-bit ``atomicMax``. Details in the source.
- No single PyTorch call computes this function, so the kernel has no
  library yardstick.

Rounding: the bid is rounded as the JAX package's dense round rounds it on
the CPU, where XLA contracts a multiply and the add after it into one fused
multiply-add. With affinity that is

    aff = fma(d2, f2, fma(d1, f1, d0·f0))
    bid = fma(hash, jitter, w·(−aff)) − price

each step rounded once; at ``affinity_weight == 0`` it is
``hash·jitter − price``, two roundings. The kernel spells every step with
an ``_rn`` intrinsic (``__fmaf_rn`` for the fused ones; the library is built
with ``--fmad=false``, so nothing else is contracted), and the plain version
with :func:`fma_f32` for the fused ones, so the two agree bit for bit at any
``jitter`` and ``affinity_weight``, and both with the reference's dense path.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np
import torch

from slurm_bridge_tpu_torch import BUILD_DIR

#: Plain-version tile shape: pod rows × nodes per tile (the TPU kernel's
#: defaults). Only the plain version tiles; the CUDA kernel stages its own
#: node tiles in shared memory.
BP = 512
BN = 2048

#: Launches of the CUDA kernel (the scoring kernel, one per wrapper call)
#: since the count was last zeroed; plain-version calls do not add to it.
LAUNCHES = 0
#: Launches of the kernel's four helpers (the work list's count and compact
#: passes, node packing, per-row finish).
AUX_LAUNCHES = 0

#: Rows per work item — ``kTileRows`` of ``csrc/bid_argmax.cu`` (the C
#: entry point refuses another) — and rows of the row order per work-list
#: block (``kSlice``).
TILE_ROWS = 512
LIST_SLICE = 1024

#: Instructions per needed (shard, node) cell in the kernel's cell loop at
#: ``affinity_weight == 0``, by the pipe that issues them, counted from its
#: SASS (``tools/port_sass.py``: ``cuobjdump -sass`` of the ``sm_90a``
#: build, the ``bid_argmax_score<false>`` instantiation): one pass of the
#: loop scores two staged nodes against a thread's four rows in 240
#: instructions — integer 158 (LOP3 64, IMAD 32, SHF 40, ISETP 9, PLOP3 8,
#: VIADD 5), f32 64 (FSETP 40, FMUL 16, FADD 8), conversion 8 (I2FP),
#: shared loads 4 (LDS.128) and branch and uniform bookkeeping 6.
CELL_OPS = dict(int=158 / 8, f32=64 / 8, cvt=8 / 8, lds=4 / 8)
#: The same with the affinity term (``bid_argmax_score<true>``, 277
#: instructions a pass): f32 96 (FSETP 40, FFMA 24, FMUL 24, FADD 8) — per
#: cell the chain's FMUL and two FFMAs and ``w·(−aff)``'s FMUL, the
#: jitter's FMUL turned FFMA — shared loads 6 (the affinity record's too).
CELL_OPS_AFF = dict(int=158 / 8, f32=96 / 8, cvt=8 / 8, lds=6 / 8)
#: Arithmetic operations per needed cell (for the roofline bound).
OPS_PER_CELL = CELL_OPS["int"] + CELL_OPS["f32"] + CELL_OPS["cvt"]

_SRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "bid_argmax.cu"
_LIB = BUILD_DIR / "libsbt_bid_argmax.so"
_lock = threading.Lock()
_fn = None


class KernelBuildError(RuntimeError):
    """nvcc missing or the compile failed; the message carries its output."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME/bin)")


def build(force: bool = False) -> str:
    """Compile ``csrc/bid_argmax.cu`` for ``sm_90a`` into the build
    directory (if missing, stale, or ``force``). Returns the compiler's
    output, which carries ``ptxas``'s register and shared-memory report;
    an empty string when the cached library was current."""
    with _lock:
        if (
            not force
            and _LIB.exists()
            and _LIB.stat().st_mtime >= _SRC.stat().st_mtime
        ):
            return ""
        _LIB.parent.mkdir(parents=True, exist_ok=True)
        tmp = _LIB.with_name(f".{_LIB.name}.{os.getpid()}.tmp")
        cmd = [
            _nvcc(),
            "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
            "-shared", "-Xcompiler", "-fPIC",
            "-o", str(tmp), str(_SRC),
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise KernelBuildError(
                f"nvcc failed building {_LIB.name} (rc={proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, _LIB)
        return proc.stdout + proc.stderr


def _kernel():
    """The bound C library, built at first use."""
    global _fn
    if _fn is None:
        build()
        lib = ctypes.CDLL(str(_LIB))
        lib.sbt_bid_argmax.restype = ctypes.c_int
        lib.sbt_bid_argmax.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ] + [ctypes.c_void_p] * 6
        lib.sbt_work_list.restype = ctypes.c_int
        lib.sbt_work_list.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [
            ctypes.c_void_p
        ] * 4
        _fn = lib
    return _fn


def _raise_on(rc: int, what: str) -> None:
    if rc == -1:
        raise RuntimeError(f"{what}: {_LIB.name} was built for another tile size")
    if rc == -2:
        raise ValueError(f"{what}: the node axis needs more chunks than a grid holds")
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


#: operand name → (dtype, trailing shape); node_feat/req_feat are uint32
#: bit patterns carried in int32 tensors
_NODE_OPS = (
    ("free", torch.float32, (3,)),
    ("node_part", torch.int32, ()),
    ("node_feat", torch.int32, ()),
    ("price", torch.float32, ()),
    ("free_n", torch.float32, (3,)),
)
_POD_OPS = (
    ("dem", torch.float32, (3,)),
    ("job_part", torch.int32, ()),
    ("req_feat", torch.int32, ()),
    ("incumbent", torch.int32, ()),
    ("dem_n", torch.float32, (3,)),
)


def _check(ops: dict[str, torch.Tensor]) -> tuple[int, int, torch.device]:
    device = ops["free"].device
    n, p = ops["free"].shape[0], ops["dem"].shape[0]
    for group, rows in ((_NODE_OPS, n), (_POD_OPS, p)):
        for name, dtype, tail in group:
            t = ops[name]
            if t.device != device:
                raise ValueError(f"bid_argmax: {name} on {t.device}, free on {device}")
            if t.dtype != dtype:
                raise TypeError(f"bid_argmax: {name} is {t.dtype}, want {dtype}")
            if tuple(t.shape) != (rows, *tail):
                raise ValueError(
                    f"bid_argmax: {name} has shape {tuple(t.shape)}, want {(rows, *tail)}"
                )
            if not t.is_contiguous():
                raise ValueError(f"bid_argmax: {name} is not contiguous")
    return p, n, device


def node_order(partition_of, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The nodes grouped by partition, ascending node index within one, and
    the offsets of each partition's run: partition ``q`` holds
    ``order[offsets[q]:offsets[q + 1]]``. Nodes of a negative partition
    come first (only rows of any partition take them). Built on the host
    from ``partition_of`` ([N] ints, numpy or a tensor); the partition codes
    are dense (the encoder's 0..K-1). Returns (order [N] i32, offsets
    [K+1] i32) on ``device``."""
    if isinstance(partition_of, torch.Tensor):
        partition_of = partition_of.cpu().numpy()
    part = np.asarray(partition_of, dtype=np.int64)
    order = np.argsort(part, kind="stable")
    k = int(part.max()) + 1 if part.size and part.max() >= 0 else 0
    if k > 2 * part.size + 1024:
        raise ValueError(f"node_order: partition code {k - 1} is not dense")
    offsets = np.searchsorted(part[order], np.arange(k + 1), side="left")
    return (
        torch.from_numpy(order.astype(np.int32)).to(device),
        torch.from_numpy(offsets.astype(np.int32)).to(device),
    )


def row_order(job_part: torch.Tensor) -> torch.Tensor:
    """The row ids [P] i32 stably sorted by partition (rows of any
    partition, ``job_part < 0``, first), on the rows' device without a
    host sync."""
    return torch.sort(job_part, stable=True).indices.to(torch.int32)


def work_list(live: torch.Tensor | None, order: torch.Tensor):
    """The live rows compacted in ``order`` (:func:`row_order`) and their
    count, without a host sync (see :func:`work_list_plain`). On a CUDA
    tensor two short kernels build it; on a CPU tensor the plain version
    does."""
    global AUX_LAUNCHES
    if order.device.type != "cuda":
        return work_list_plain(live, order)
    p = order.shape[0]
    device = order.device
    rows = torch.empty(p, dtype=torch.int32, device=device)
    count = (torch.empty if p else torch.zeros)(1, dtype=torch.int32, device=device)
    slice_counts = torch.empty(max(1, -(-p // LIST_SLICE)), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        rc = _kernel().sbt_work_list(
            0 if live is None else live.data_ptr(), order.data_ptr(), p,
            slice_counts.data_ptr(), rows.data_ptr(), count.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _raise_on(rc, "bid_argmax work list")
    AUX_LAUNCHES += 2
    return rows, count


def work_list_plain(live: torch.Tensor | None, order: torch.Tensor):
    """The plain version of the kernel's work list, in PyTorch ops without
    a host sync: the live rows in ``order`` compacted to the front (−1
    after them) and their count as a [1] i32 tensor the host never reads.
    ``live`` is [P] bool by row id; ``None`` means every row."""
    p = order.shape[0]
    device = order.device
    if live is None:
        live_s = torch.ones(p, dtype=torch.bool, device=device)
    else:
        live_s = live[order.long()]
    pos = torch.cumsum(live_s, 0, dtype=torch.int32)  # inclusive
    dest = torch.where(live_s, pos - 1, p).long()  # dead rows to a spare slot
    rows = torch.full((p + 1,), -1, dtype=torch.int32, device=device)
    rows.scatter_(0, dest, order)
    return rows[:p], pos[-1:]


def tile_ranges(
    rows: torch.Tensor, count: torch.Tensor, job_part: torch.Tensor,
    offsets: torch.Tensor, num_nodes: int, tile_rows: int = TILE_ROWS,
):
    """For each tile of ``tile_rows`` rows of the work list, the range
    ``[lo, hi)`` of the :func:`node_order` list it walks — what each block
    of the kernel computes for itself.

    The range runs from the tile's first live row's partition to its last's
    (rows are sorted, so it covers every partition in between); it is the
    whole list if the tile holds a row of any partition, empty for a
    partition without nodes or a code past the offsets, and (0, 0) for a
    tile past the live count. Rows of another partition inside a
    straddling tile fail the kernel's partition test, as they would on any
    node. Returns (lo, hi), [tiles] i32 each."""
    p = rows.shape[0]
    device = rows.device
    tiles = -(-p // tile_rows)
    first = torch.arange(tiles, device=device) * tile_rows
    last = (torch.minimum(first + tile_rows, count) - 1).clamp_min(0)
    part = torch.where(rows >= 0, job_part[rows.clamp_min(0).long()], 0).long()
    pf, pl = part[first], part[last]
    k = offsets.shape[0] - 1
    lo = offsets[pf.clamp(0, k)]
    hi = offsets[(pl + 1).clamp(0, k)]
    wild = pf < 0
    lo = torch.where(wild, 0, lo)
    hi = torch.where(wild, num_nodes, hi)
    has = first < count
    return torch.where(has, lo, 0).to(torch.int32), torch.where(has, hi, 0).to(torch.int32)


def bid_argmax(
    free, node_part, node_feat, price, dem, job_part, req_feat, incumbent,
    dem_n, free_n, salt: int, p_base: int = 0, n_base: int = 0,
    *, jitter: float, affinity_weight: float, num_nodes: int,
    live: torch.Tensor | None = None,
    nodes: tuple[torch.Tensor, torch.Tensor] | None = None,
    rows: torch.Tensor | None = None,
):
    """Best feasible (value, node) per shard. Returns (best [P] f32,
    choice [P] i32) with ``choice == num_nodes`` where nothing is feasible.

    ``free``/``free_n`` [N, 3] f32, ``node_part`` [N] i32, ``node_feat``
    [N] (uint32 bits in i32), ``price`` [N] f32; ``dem``/``dem_n`` [P, 3]
    f32, ``job_part``/``incumbent`` [P] i32, ``req_feat`` [P] (uint32 bits
    in i32); all contiguous and on one device. ``p_base``/``n_base`` are
    the global offsets of this block (hash and returned node ids are
    global). ``live`` ([P] bool, ``None`` = every row) marks the rows to
    score; the others return (−inf, ``num_nodes``). CPU tensors run
    :func:`bid_argmax_plain`; CUDA tensors launch the kernel.

    ``nodes`` (:func:`node_order` of ``node_part``) and ``rows``
    (:func:`row_order` of ``job_part``) only change with the inventory and
    the queue: a caller that calls once per round builds them once. Left
    out, they are built here, and ``nodes`` then reads ``node_part`` on
    the host.
    """
    global LAUNCHES, AUX_LAUNCHES
    ops = dict(
        free=free, node_part=node_part, node_feat=node_feat, price=price,
        free_n=free_n, dem=dem, job_part=job_part, req_feat=req_feat,
        incumbent=incumbent, dem_n=dem_n,
    )
    p, n, device = _check(ops)
    if live is not None and (
        live.dtype != torch.bool or tuple(live.shape) != (p,) or live.device != device
    ):
        raise ValueError(f"bid_argmax: live must be bool [{p}] on {device}")
    if device.type == "cpu":
        return bid_argmax_plain(
            free, node_part, node_feat, price, dem, job_part, req_feat,
            incumbent, dem_n, free_n, salt, p_base, n_base,
            jitter=jitter, affinity_weight=affinity_weight, num_nodes=num_nodes,
            live=live,
        )
    if device.type != "cuda":
        raise ValueError(f"bid_argmax: unsupported device {device}")
    if p == 0 or n == 0:
        return (
            torch.full((p,), float("-inf"), dtype=torch.float32, device=device),
            torch.full((p,), num_nodes, dtype=torch.int32, device=device),
        )
    if nodes is None:
        nodes = node_order(node_part, device)
    if rows is None:
        rows = row_order(job_part)
    rows_c, count = work_list(live, rows)
    order, offsets = nodes
    rec = torch.empty((n, 8), dtype=torch.int32, device=device)
    rec_aff = torch.empty((n if affinity_weight else 1, 4), dtype=torch.int32, device=device)
    keys = torch.empty(p, dtype=torch.int64, device=device)
    best = torch.empty(p, dtype=torch.float32, device=device)
    choice = torch.empty(p, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _kernel().sbt_bid_argmax(
            free.data_ptr(), node_part.data_ptr(), node_feat.data_ptr(),
            price.data_ptr(), dem.data_ptr(), job_part.data_ptr(),
            req_feat.data_ptr(), incumbent.data_ptr(), dem_n.data_ptr(),
            free_n.data_ptr(), order.data_ptr(), offsets.data_ptr(),
            rows_c.data_ptr(), count.data_ptr(), offsets.shape[0] - 1,
            p, n, TILE_ROWS, _i32(salt), _i32(p_base), _i32(n_base),
            float(jitter), float(affinity_weight), int(num_nodes),
            rec.data_ptr(), rec_aff.data_ptr(), keys.data_ptr(),
            best.data_ptr(), choice.data_ptr(), stream,
        )
    _raise_on(rc, "bid_argmax kernel")
    LAUNCHES += 1
    AUX_LAUNCHES += 2
    return best, choice


def _i32(x: int) -> int:
    """An int as the C side's int32: two's-complement wrap of its low 32
    bits (offsets near 2^31 and salts address the same uint32 hash space)."""
    x = int(x) & 0xFFFFFFFF
    return x - (1 << 32) if x >= 1 << 31 else x


_M32 = 0xFFFFFFFF


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a · c) mod 2^32`` for int64 ``a`` in [0, 2^32) and a uint32
    constant, without int64 overflow: split ``c`` into 16-bit halves."""
    lo = a * (c & 0xFFFF)  # < 2^48
    hi = (a * (c >> 16)) & 0xFFFF  # only its low 16 bits survive the shift
    return (lo + (hi << 16)) & _M32


def mix(pi: torch.Tensor, ni: torch.Tensor, salt: int) -> torch.Tensor:
    """Murmur-style avalanche of (row, col, salt) uint32 streams, carried
    in int64 tensors (CPU torch has no uint32 ``>>``; int32 ``>>`` is
    arithmetic). ``pi``/``ni`` hold values in [0, 2^32) and broadcast."""
    h = mul32(pi, 0x9E3779B1) ^ mul32(ni, 0x85EBCA77) ^ (
        (salt & _M32) * 0xC2B2AE3D & _M32
    )
    h = h ^ (h >> 16)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def unit(h: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint32 hash → [0, 1): top 24 bits, exactly representable in f32."""
    return ((h >> 8).to(torch.float32) * (1.0 / (1 << 24))).to(dtype)


def fma_f32(a, b, c) -> torch.Tensor:
    """``a·b + c`` rounded once to float32 — what CUDA's ``__fmaf_rn``
    returns, and the fused multiply-add XLA's CPU backend contracts a
    multiply and an add into — for float32 tensors or Python floats
    (rounded to float32 first), broadcast. Torch has no fused multiply-add
    that rounds once on every device.

    The product of two float32 values is exact in float64. The float64 sum
    is rounded to odd: its exact error (a two-sum) decides whether the last
    bit is set, so no float64 value that lies on a float32 halfway point
    stands for a sum that does not. Float64 keeps 29 bits more than
    float32, so the one rounding to float32 after it is the correctly
    rounded sum: no double rounding. (A plain float64 ``a·b + c`` rounded
    to float32 would differ where the exact sum needs more than 53 bits and
    its float64 rounding lands on a halfway point, e.g. a = 2^-24·(1 −
    2^-23), b = c = 1 + 2^-23.)"""
    a, b, c = (torch.as_tensor(x, dtype=torch.float32).double() for x in (a, b, c))
    p = a * b
    s = p + c
    v = s - p  # two-sum: s + e == p + c exactly
    e = (p - (s - v)) + (c - v)
    bits = s.view(torch.int64)
    inexact = (e != 0) & torch.isfinite(s)
    # toward zero (one step down in magnitude where s rounded away), then
    # the last bit set: the neighbour of the exact sum whose last bit is odd
    bits = torch.where(inexact & ((e < 0) != (s < 0)), bits - 1, bits)
    bits = torch.where(inexact, bits | 1, bits)
    return bits.view(torch.float64).float()


def affinity_fma(dem_n: torch.Tensor, free_n: torch.Tensor) -> torch.Tensor:
    """``Σ_r dem_n[..., r]·free_n[..., r]`` (operands broadcast) as XLA's
    CPU backend computes the reference's 3-term product: the fused chain
    ``fma(d2, f2, fma(d1, f1, d0·f0))``, each step rounded once."""
    aff = dem_n[..., 0] * free_n[..., 0]
    for r in range(1, dem_n.shape[-1]):
        aff = fma_f32(dem_n[..., r], free_n[..., r], aff)
    return aff


def bid_argmax_plain(
    free, node_part, node_feat, price, dem, job_part, req_feat, incumbent,
    dem_n, free_n, salt: int, p_base: int = 0, n_base: int = 0,
    *, jitter: float, affinity_weight: float, num_nodes: int,
    live: torch.Tensor | None = None, bp: int = BP, bn: int = BN,
):
    """The plain PyTorch version of the kernel, on any device: the TPU
    kernel's tiling (``bp`` rows × ``bn`` nodes), padding (padded nodes
    advertise free −1 and partition −2), global offsets and running
    (max, argmax) with a strictly-greater update across node tiles — the
    first maximal node wins, as in the kernel. With ``live``, only the live
    rows are scored (an index-select), each still over every node; the
    others return (−inf, ``num_nodes``)."""
    p, n = dem.shape[0], free.shape[0]
    device = dem.device
    n_pad = (-n) % bn
    free = torch.cat([free, free.new_full((n_pad, 3), -1.0)])
    node_part = torch.cat([node_part, node_part.new_full((n_pad,), -2)])
    node_feat = torch.cat([node_feat, node_feat.new_zeros(n_pad)])
    price = torch.cat([price, price.new_zeros(n_pad)])
    free_n = torch.cat([free_n, free_n.new_zeros((n_pad, 3))])
    cap = free + 1e-6
    feat64 = node_feat.to(torch.int64) & _M32
    best = torch.full((p,), float("-inf"), dtype=torch.float32, device=device)
    choice = torch.full((p,), num_nodes, dtype=torch.int32, device=device)
    if live is None:
        row_ids = torch.arange(p, device=device)
    else:
        row_ids = torch.nonzero(live).squeeze(1)
    for i in range(0, row_ids.shape[0], bp):
        rows = row_ids[i : i + bp]
        jp = job_part[rows, None]
        rf = req_feat[rows, None].to(torch.int64) & _M32
        d = dem[rows]
        dn = dem_n[rows]
        inc = incumbent[rows, None]
        pi = (rows + p_base) & _M32
        b_val = best[rows]
        b_idx = choice[rows]
        for j in range(0, n + n_pad, bn):
            cols = slice(j, j + bn)
            ni32 = (torch.arange(j, j + bn, device=device) + n_base) & _M32
            ok = (jp == node_part[None, cols]) | (jp < 0)
            ok &= (feat64[None, cols] & rf) == rf
            for r in range(3):
                ok &= d[:, r : r + 1] <= cap[None, cols, r]
            ni = torch.where(ni32 >= 1 << 31, ni32 - (1 << 32), ni32)  # as int32
            ok &= (inc < 0) | (ni[None, :] == inc)
            jit = unit(mix(pi[:, None], ni32[None, :], salt))
            if affinity_weight != 0.0:
                aff = affinity_fma(dn[:, None, :], free_n[None, cols, :])
                # best-fit: least free wins
                bid = fma_f32(jit, jitter, affinity_weight * -aff) - price[None, cols]
            else:
                bid = jit * jitter - price[None, cols]
            val = torch.where(ok, bid, float("-inf"))
            t_arg = val.argmax(dim=1)  # first maximal node of the tile
            t_max = val.gather(1, t_arg[:, None])[:, 0]
            better = t_max > b_val
            b_idx = torch.where(better, ni[t_arg].to(torch.int32), b_idx)
            b_val = torch.where(better, t_max, b_val)
        best[rows] = b_val
        choice[rows] = b_idx
    return best, choice
