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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-src", required=True)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    dev = torch.device("cuda")
    smi = smi_line()
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
