"""What the fake Slurm CLI (``tests/fakeslurm``) costs on this machine, at
the inventory chip_smoke.py's bridge phase gives it.

The shim answers ``scontrol show nodes`` by reading every job record in
its state directory once per node it prints (the CPUs a running job
holds), so one inventory fetch costs O(nodes × jobs) file reads, and each
``sbatch`` is a Python process start. The bridge phase's run to
completion waits on both: its job count is chosen from these numbers.

Prints, for a fresh state directory under ``$TMPDIR`` holding the
headline inventory (``bridge_inventory`` at 10,000 nodes), the mean time
of one ``sbatch``, and the time of one ``scontrol show nodes`` over the
first partition's nodes with ``--jobs`` job records present (each also
per node and job).

    python3 tools/fakeslurm_cost.py [--jobs 20 100] [--sbatch 20]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from chip_smoke import BRIDGE, bridge_inventory, fake_cluster  # noqa: E402


def job_record(state: str, jid: int) -> None:
    """One ended job as the shim keeps it: its record, exit code, stdout
    and script."""
    with open(os.path.join(state, f"job_{jid}.json"), "w") as f:
        json.dump({"id": jid, "cancelled": False, "tasks": [
            {"jid": jid, "pid": 1, "node": "node00001", "cpus": 1, "task_id": None}]}, f)
    for name in (f"exit_{jid}", f"slurm-{jid}.out", f"job_{jid}.sh"):
        with open(os.path.join(state, name), "w") as f:
            f.write("0\n")


def main() -> None:
    from slurm_bridge_tpu_torch.solver.snapshot import random_inventory

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--jobs", type=int, nargs="+", default=[20, 100])
    ap.add_argument("--sbatch", type=int, default=20, help="sbatch calls to time")
    args = ap.parse_args()
    partitions, nodes, _ = bridge_inventory(random_inventory, BRIDGE["num_nodes"], 1)
    names = list(partitions[0].nodes)
    state = tempfile.mkdtemp(prefix="sbt-shim-cost-")
    try:
        with open(os.path.join(state, "cluster.json"), "w") as f:
            json.dump(fake_cluster(partitions, nodes), f)
        env = dict(os.environ, SBT_FAKESLURM_STATE=state,
                   PATH=os.path.join(REPO, "tests", "fakeslurm") + os.pathsep + os.environ["PATH"])
        t0 = time.perf_counter()
        for _ in range(args.sbatch):
            subprocess.run(["sbatch", "--parsable", "--partition", partitions[0].name],
                           input="#!/bin/sh\necho x\n", text=True, env=env,
                           capture_output=True, check=True)
        sbatch_ms = (time.perf_counter() - t0) / args.sbatch * 1e3
        # the submitted jobs' records count as job records too
        have = args.sbatch
        for jobs in sorted(args.jobs):
            for j in range(have, jobs):
                job_record(state, 100_000 + j)
            have = max(have, jobs)
            t0 = time.perf_counter()
            subprocess.run(["scontrol", "show", "nodes", ",".join(names)], env=env,
                           stdout=subprocess.DEVNULL, check=True)
            secs = time.perf_counter() - t0
            print(json.dumps({
                "state_dir": tempfile.gettempdir(), "nodes": len(names), "jobs": have,
                "scontrol_show_nodes_s": round(secs, 3),
                "us_per_node_and_job": round(secs / len(names) / have * 1e6, 1),
                "sbatch_ms": round(sbatch_ms, 1),
            }), flush=True)
    finally:
        shutil.rmtree(state, ignore_errors=True)


if __name__ == "__main__":
    main()
