"""Time the one-thread-per-row ``bid_argmax`` kernel beside the checkout's.

The first CUDA version of the kernel (commit 625296e,
``slurm_bridge_tpu_torch/csrc/bid_argmax.cu``) scored every row against
every node, one thread per row. This builds a copy of that source with the
same flags as the checkout's kernel, checks that both give the same
(value, choice) on one round's operands of the 57,635 × 10,000 headline
solve with every row live, and times both with CUDA events behind
chip_smoke.py's gate (device time, not the host's launch rate) in turns:
old, new, new, old. The new kernel's node and row orders are built once,
as the solve builds them. Needs a CUDA card and ``nvcc``.

    git show 625296e:slurm_bridge_tpu_torch/csrc/bid_argmax.cu > scratch_checkout/old.cu
    python tools/port_kernel_ab.py --old-src scratch_checkout/old.cu

``--parent-src F`` instead times a source ``F`` with the checkout's C entry
points (an earlier version of ``csrc/bid_argmax.cu``, e.g. the parent
commit's) beside the checkout's kernel, both through the wrapper
``ops/bid_argmax.py:bid_argmax`` on the same headline operands, every row
live, in turns parent, new, new, parent: at ``affinity_weight=0``, where
both must give the same bits, and at 0.05, where the two may round the
bid differently (it prints how many values differ).

    git show HEAD~1:slurm_bridge_tpu_torch/csrc/bid_argmax.cu > scratch_checkout/parent.cu
    python tools/port_kernel_ab.py --parent-src scratch_checkout/parent.cu
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import slurm_bridge_tpu_torch.ops.bid_argmax as kern  # noqa: E402
from chip_smoke import HEADLINE, cuda_ms, round_operands, smi_line  # noqa: E402
from slurm_bridge_tpu_torch.solver.snapshot import random_scenario  # noqa: E402


def build_old(src: str) -> ctypes.CDLL:
    out = kern.BUILD_DIR / "libsbt_bid_argmax_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        [kern._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-o", str(out), src],
        check=True, capture_output=True, text=True,
    )
    fn = ctypes.CDLL(str(out)).sbt_bid_argmax
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return fn


def build_parent(src: str) -> ctypes.CDLL:
    """``src`` built as the checkout's kernel is, with its entry points
    typed as the wrapper types the checkout's."""
    out = kern.BUILD_DIR / "libsbt_bid_argmax_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        [kern._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-o", str(out), src],
        check=True, capture_output=True, text=True,
    )
    lib, new = ctypes.CDLL(str(out)), kern._kernel()
    for name in ("sbt_bid_argmax", "sbt_work_list"):
        getattr(lib, name).restype = getattr(new, name).restype
        getattr(lib, name).argtypes = getattr(new, name).argtypes
    return lib


def parent_ab(src: str, reps: int, smi: str) -> dict:
    dev = torch.device("cuda")
    libs = {"parent": build_parent(src), "new": kern._kernel()}
    snap, batch = random_scenario(**HEADLINE)
    ops = round_operands(snap, batch, dev)
    p, n = batch.num_shards, snap.num_nodes
    orders = dict(nodes=kern.node_order(snap.partition_of, dev), rows=kern.row_order(ops[5]))

    def run(name, aw):
        kern._fn = libs[name]
        try:
            return kern.bid_argmax(*ops, 3, jitter=1.0, affinity_weight=aw, num_nodes=n, **orders)
        finally:
            kern._fn = libs["new"]

    out = {"shape": [p, n], "rows_live": p, "reps": reps}
    for aw in (0.0, 0.05):
        (pv, pi), (nv, ni) = run("parent", aw), run("new", aw)
        torch.cuda.synchronize()
        differ = int(((pv.view(torch.int32) != nv.view(torch.int32)) | (pi != ni)).sum())
        if aw == 0.0 and differ:
            raise SystemExit(f"parent and new kernels disagree at affinity_weight=0 ({differ} rows)")
        for _ in range(3):
            run("parent", aw)
            run("new", aw)
        times = {"parent": [], "new": []}
        for name in ("parent", "new", "new", "parent"):
            times[name].append(cuda_ms(lambda: run(name, aw), reps))
        out[f"aw={aw}"] = {"parent_ms_per_launch": times["parent"],
                           "new_ms_per_launch": times["new"], "rows_differing": differ}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src")
    ap.add_argument("--parent-src")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if bool(args.old_src) == bool(args.parent_src):
        ap.error("give one of --old-src, --parent-src")
    dev = torch.device("cuda")
    smi = smi_line()
    if args.parent_src:
        res = parent_ab(args.parent_src, args.reps, smi)
        print(f"card: {smi}")
        print(json.dumps(res))
        return
    old = build_old(args.old_src)
    snap, batch = random_scenario(**HEADLINE)
    ops = round_operands(snap, batch, dev)
    p, n = batch.num_shards, snap.num_nodes
    best = torch.empty(p, dtype=torch.float32, device=dev)
    choice = torch.empty(p, dtype=torch.int32, device=dev)

    def run_old():
        rc = old(*[t.data_ptr() for t in ops], p, n, 3, 0, 0, 1.0, 0.0, n,
                 best.data_ptr(), choice.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"old kernel: cudaError {rc}")

    kw = dict(jitter=1.0, affinity_weight=0.0, num_nodes=n,
              nodes=kern.node_order(snap.partition_of, dev), rows=kern.row_order(ops[5]))

    def run_new():
        return kern.bid_argmax(*ops, 3, **kw)

    run_old()
    nv, ni = run_new()
    torch.cuda.synchronize()
    if not (torch.equal(best, nv) and torch.equal(choice, ni)):
        raise SystemExit("old and new kernels disagree")
    for _ in range(3):
        run_old()
        run_new()
    times = {"old": [], "new": []}
    for name in ("old", "new", "new", "old"):
        times[name].append(cuda_ms(run_old if name == "old" else run_new, args.reps))
    print(f"card: {smi}")
    print(json.dumps({
        "shape": [p, n], "rows_live": p, "reps": args.reps,
        "old_ms_per_launch": times["old"], "new_ms_per_launch": times["new"],
        "speedup": float(np.mean(times["old"]) / np.mean(times["new"])),
    }))


if __name__ == "__main__":
    main()
