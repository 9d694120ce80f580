"""Reference numbers for the PyTorch port's on-card check (chip_smoke.py).

Runs the JAX package's auction on the CPU — dense full argmax
(``candidates=0``, ``use_pallas=False``), ``rounds=8`` — on one
``random_scenario`` and prints the placed-jobs count and the sha256 of
``node_of`` (little-endian int32). chip_smoke.py holds the port's solve on
the card to these numbers.

    JAX_PLATFORMS=cpu python tools/port_reference.py --nodes 2000 --jobs 10000
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import resource
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slurm_bridge_tpu.solver.auction import AuctionConfig, auction_place  # noqa: E402
from slurm_bridge_tpu.solver.snapshot import random_scenario  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=2000)
    ap.add_argument("--jobs", type=int, default=10000)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args()
    snap, batch = random_scenario(
        args.nodes, args.jobs, seed=args.seed, load=0.7,
        gpu_fraction=0.15, gang_fraction=0.05,
    )
    cfg = AuctionConfig(rounds=8, candidates=0, use_pallas=False)
    t0 = time.perf_counter()
    pl = auction_place(snap, batch, cfg)
    secs = time.perf_counter() - t0
    print(json.dumps({
        "scenario": {"nodes": args.nodes, "jobs": args.jobs, "seed": args.seed,
                     "load": 0.7, "gpu_fraction": 0.15, "gang_fraction": 0.05},
        "shards": batch.num_shards,
        "config": "AuctionConfig(rounds=8, candidates=0, use_pallas=False)",
        "placed_jobs": len(pl.by_job(batch)),
        "placed_shards": int(pl.placed.sum()),
        "node_of_sha256": hashlib.sha256(pl.node_of.astype("<i4").tobytes()).hexdigest(),
        "cpu_seconds_wall": round(secs, 3),
        "max_rss_mib": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024,
    }))


if __name__ == "__main__":
    main()
