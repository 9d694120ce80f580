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

Source note:

- Replaces the Pallas TPU kernel ``slurm_bridge_tpu/ops/bid_argmax.py:_kernel``
  (wrapper ``bid_argmax``), with the same inputs, outputs, sentinel
  (``choice == num_nodes`` where nothing is feasible), lowest-index tie
  rule and global ``p_base``/``n_base`` offsets.
- What bounds it on the card: integer and f32 ALU issue, not memory. The
  operands are O((P+N)·R) words; each of the P·N cells costs
  :data:`OPS_PER_CELL` ALU operations once the per-row and per-salt hash
  terms are hoisted (counted from the kernel's cell loop: hash 11,
  jitter 3, feasibility 13, running argmax 3). At the 57,635 × 10,000
  headline round that is 576 M cells.
- What the design does about it: one thread per pod row with its
  operands in registers, node tiles staged once per block in shared memory
  and read as broadcasts, the row and node hash terms hoisted out of the
  cell loop. One thread per row leaves most of the card's resident-thread
  capacity unused at the headline shape — the known limit, left for a
  later change.
- No single PyTorch call computes this function, so the kernel has no
  library yardstick.

Every f32 operation of the kernel is a separately rounded ``_rn`` intrinsic
(and the library is built with ``--fmad=false``), and every operation of
the plain version is a separate PyTorch op, so the two agree bit for bit at
any ``jitter`` and ``affinity_weight``.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

import torch

from slurm_bridge_tpu_torch import BUILD_DIR

#: Plain-version tile shape: pod rows × nodes per tile (the TPU kernel's
#: defaults). Only the plain version tiles; the CUDA kernel stages its own
#: node tiles in shared memory.
BP = 512
BN = 2048

#: Launches of the CUDA kernel since the count was last zeroed. Only the
#: wrapper's launch adds to it; plain-version calls do not.
LAUNCHES = 0

#: ALU operations per (shard, node) cell in the kernel's cell loop, after
#: hoisting: the hash's xor with the row term, three xor-shifts (2 each)
#: and two multiplies (11); jitter: convert, scale, times jitter, minus
#: price (3 after the exact scale); feasibility: partition compare, any-
#: partition test and or (3), feature and+compare (2), three capacity
#: compares and their ands (5), the node index and the incumbent test (3);
#: the running argmax: and, compare, select (3). ``affinity_weight == 0``
#: (the default) skips the affinity term.
OPS_PER_CELL = 11 + 3 + 13 + 3

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
    """The bound C entry point, built at first use."""
    global _fn
    if _fn is None:
        build()
        fn = ctypes.CDLL(str(_LIB)).sbt_bid_argmax
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _fn = fn
    return _fn


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


def bid_argmax(
    free, node_part, node_feat, price, dem, job_part, req_feat, incumbent,
    dem_n, free_n, salt: int, p_base: int = 0, n_base: int = 0,
    *, jitter: float, affinity_weight: float, num_nodes: int,
):
    """Best feasible (value, node) per shard. Returns (best [P] f32,
    choice [P] i32) with ``choice == num_nodes`` where nothing is feasible.

    ``free``/``free_n`` [N, 3] f32, ``node_part`` [N] i32, ``node_feat``
    [N] (uint32 bits in i32), ``price`` [N] f32; ``dem``/``dem_n`` [P, 3]
    f32, ``job_part``/``incumbent`` [P] i32, ``req_feat`` [P] (uint32 bits
    in i32); all contiguous and on one device. ``p_base``/``n_base`` are
    the global offsets of this block (hash and returned node ids are
    global). CPU tensors run :func:`bid_argmax_plain`; CUDA tensors launch
    the kernel.
    """
    global LAUNCHES
    ops = dict(
        free=free, node_part=node_part, node_feat=node_feat, price=price,
        free_n=free_n, dem=dem, job_part=job_part, req_feat=req_feat,
        incumbent=incumbent, dem_n=dem_n,
    )
    p, n, device = _check(ops)
    if device.type == "cpu":
        return bid_argmax_plain(
            free, node_part, node_feat, price, dem, job_part, req_feat,
            incumbent, dem_n, free_n, salt, p_base, n_base,
            jitter=jitter, affinity_weight=affinity_weight, num_nodes=num_nodes,
        )
    if device.type != "cuda":
        raise ValueError(f"bid_argmax: unsupported device {device}")
    best = torch.empty(p, dtype=torch.float32, device=device)
    choice = torch.empty(p, dtype=torch.int32, device=device)
    fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            free.data_ptr(), node_part.data_ptr(), node_feat.data_ptr(),
            price.data_ptr(), dem.data_ptr(), job_part.data_ptr(),
            req_feat.data_ptr(), incumbent.data_ptr(), dem_n.data_ptr(),
            free_n.data_ptr(), p, n, _i32(salt), _i32(p_base), _i32(n_base),
            float(jitter), float(affinity_weight), int(num_nodes),
            best.data_ptr(), choice.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"bid_argmax kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
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


def bid_argmax_plain(
    free, node_part, node_feat, price, dem, job_part, req_feat, incumbent,
    dem_n, free_n, salt: int, p_base: int = 0, n_base: int = 0,
    *, jitter: float, affinity_weight: float, num_nodes: int,
    bp: int = BP, bn: int = BN,
):
    """The plain PyTorch version of the kernel, on any device: the TPU
    kernel's tiling (``bp`` rows × ``bn`` nodes), padding (padded nodes
    advertise free −1 and partition −2), global offsets and running
    (max, argmax) with a strictly-greater update across node tiles — the
    first maximal node wins, as in the kernel."""
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
    for i in range(0, p, bp):
        rows = slice(i, min(i + bp, p))
        jp = job_part[rows, None]
        rf = req_feat[rows, None].to(torch.int64) & _M32
        d = dem[rows]
        dn = dem_n[rows]
        inc = incumbent[rows, None]
        pi = (torch.arange(rows.start, rows.stop, device=device) + p_base) & _M32
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
            bid = jit * jitter - price[None, cols]
            if affinity_weight != 0.0:
                aff = dn[:, 0:1] * free_n[None, cols, 0]
                aff = aff + dn[:, 1:2] * free_n[None, cols, 1]
                aff = aff + dn[:, 2:3] * free_n[None, cols, 2]
                bid = bid + affinity_weight * -aff  # best-fit: least free wins
            val = torch.where(ok, bid, float("-inf"))
            t_arg = val.argmax(dim=1)  # first maximal node of the tile
            t_max = val.gather(1, t_arg[:, None])[:, 0]
            better = t_max > b_val
            b_idx = torch.where(better, ni[t_arg].to(torch.int32), b_idx)
            b_val = torch.where(better, t_max, b_val)
        best[rows] = b_val
        choice[rows] = b_idx
    return best, choice
