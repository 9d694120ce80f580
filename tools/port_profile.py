"""Where the time of one headline solve goes, on the card.

Profiles ``DeviceSolver.solve`` of the 57,635 × 10,000 headline scenario
(rounds=8, the ``bid_argmax`` kernel path) with ``torch.profiler`` after a
warm-up solve, and prints: the solve's wall time, the summed device time
of all kernels (and so the device's idle share of the solve), the device
time of the ``bid_argmax`` kernels, the count of host synchronisations
(``aten::item``, ``aten::_local_scalar_dense``, ``cudaStreamSynchronize``,
``cudaDeviceSynchronize``) in the solve, and the operators that take the
most host and device time. Needs a CUDA card.

    python tools/port_profile.py [--rows 25] [--root DIR]

``--root`` profiles the port package of another checkout (for example
an unpacked earlier commit), so two trees compare in one call.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

#: Host-side events that wait for the device.
SYNC_EVENTS = ("aten::item", "aten::_local_scalar_dense", "cudaStreamSynchronize",
               "cudaDeviceSynchronize")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=25)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from slurm_bridge_tpu_torch.solver import AuctionConfig, DeviceSolver
    from slurm_bridge_tpu_torch.solver.snapshot import random_scenario

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    snap, batch = random_scenario(10_000, 50_000, seed=42, load=0.7,
                                  gpu_fraction=0.15, gang_fraction=0.05)
    solver = DeviceSolver(snap, AuctionConfig(rounds=8))
    solver.solve(batch)  # warm-up: kernel build, allocator, first launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solver.solve(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)  # noqa: E731
    # device-side entries only (kernels, copies, memsets): an operator's own
    # row repeats the time of the kernels it launched
    device_ms = sum(dev_us(e) for e in events if e.device_type == DeviceType.CUDA) / 1e3
    kernel_ms = sum(dev_us(e) for e in events
                    if "bid_argmax" in e.key and e.device_type == DeviceType.CUDA) / 1e3
    syncs = {e.key: e.count for e in events if e.key in SYNC_EVENTS}
    print(f"card: {smi}; package: {os.path.abspath(args.root)}")
    print(json.dumps({
        "solve_wall_ms": wall_ms,
        "device_busy_ms": device_ms,
        "device_idle_share": max(0.0, 1 - device_ms / wall_ms),
        "bid_argmax_device_ms": kernel_ms,
        "bid_argmax_kernels_ms": {e.key[:60]: dev_us(e) / 1e3 for e in events
                                  if "bid_argmax" in e.key and e.device_type == DeviceType.CUDA},
        "sync_events": syncs,
    }))
    print(events.table(sort_by="self_cpu_time_total", row_limit=args.rows))
    sort_dev = "self_device_time_total" if hasattr(events[0], "self_device_time_total") else "self_cuda_time_total"
    print(events.table(sort_by=sort_dev, row_limit=args.rows))


if __name__ == "__main__":
    main()
