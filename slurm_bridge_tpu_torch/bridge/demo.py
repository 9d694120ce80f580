"""End-to-end demo: the minimum slice of SURVEY.md §7 step 4, runnable
anywhere — starts an in-process agent against the fake Slurm shim (or a
real Slurm if the binaries are on PATH and ``--real`` is passed), runs the
full bridge loop, and walks one job from submit to fetched results.

    python -m slurm_bridge_tpu_torch.bridge.demo [--scheduler auto|auction|greedy]
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import tempfile

from slurm_bridge_tpu_torch.bridge import Bridge, BridgeJobSpec
from slurm_bridge_tpu_torch.wire import serve

_FAKESLURM = pathlib.Path(__file__).resolve().parents[2] / "tests" / "fakeslurm"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="sbt-demo")
    ap.add_argument("--scheduler", choices=("auto", "auction", "greedy"),
                    default="auto")
    ap.add_argument(
        "--real", action="store_true",
        help="use the Slurm binaries already on PATH instead of the fake shim",
    )
    ap.add_argument(
        "--preemption", action="store_true",
        help="demo priority preemption instead of the basic job walk: a "
             "high-priority job displaces a running low-priority one "
             "(preempt → cancel → requeue → re-place)",
    )
    args = ap.parse_args(argv)

    tmp = tempfile.mkdtemp(prefix="sbt-demo-")
    if not args.real:
        if not _FAKESLURM.is_dir():
            print(f"fake slurm shim not found at {_FAKESLURM}", file=sys.stderr)
            return 2
        os.environ["SBT_FAKESLURM_STATE"] = os.path.join(tmp, "state")
        os.environ["PATH"] = f"{_FAKESLURM}{os.pathsep}{os.environ['PATH']}"

    from slurm_bridge_tpu_torch.agent import SlurmClient, WorkloadServicer

    if args.preemption and not args.real:
        # a cluster one job can saturate, so the priorities actually clash
        import json as _json

        state = pathlib.Path(os.environ["SBT_FAKESLURM_STATE"])
        state.mkdir(parents=True, exist_ok=True)
        (state / "cluster.json").write_text(_json.dumps({
            "partitions": {"tiny": {"nodes": ["t1"], "default": True}},
            "nodes": {"t1": {"cpus": 4, "memory_mb": 16000, "partition": "tiny"}},
        }))

    sock = os.path.join(tmp, "agent.sock")
    server = serve(
        {"WorkloadManager": WorkloadServicer(SlurmClient(), tail_poll_interval=0.02)},
        sock,
    )
    results = os.path.join(tmp, "results")
    print(f"agent up on {sock}; scheduler={args.scheduler}")
    if args.preemption:
        rc = _preemption_demo(sock, args)
        server.stop(None)
        return rc
    with Bridge(
        sock,
        scheduler_backend=args.scheduler,
        scheduler_interval=0.1,
        node_sync_interval=0.1,
    ) as bridge:
        bridge.submit(
            "demo",
            BridgeJobSpec(
                partition="debug",
                sbatch_script="#!/bin/sh\n#SBATCH --cpus-per-task=2\necho hello-from-slurm\n",
                result_to=results,
            ),
        )
        job = bridge.wait("demo", timeout=120, fetch_done=True)
        print(f"job state: {job.status.state}; fetch: {job.status.fetch_result}")
        for key, sub in job.status.subjobs.items():
            print(f"  subjob {key}: {sub.state.name} exit={sub.exit_code}")
        logs = b"".join(bridge.logs("demo"))
        print(f"logs: {logs!r}")
        for f in sorted(os.listdir(results)):
            print(f"result file {f}: {open(os.path.join(results, f), 'rb').read()!r}")
    server.stop(None)
    ok = job.status.state == "Succeeded"
    print("demo", "OK" if ok else "FAILED")
    return 0 if ok else 1


def _preemption_demo(sock: str, args) -> int:
    """BASELINE config #5 in the product path, narrated: a saturating
    low-priority job is displaced by a high-priority newcomer — preempt →
    cancel → requeue → re-place once capacity frees up."""
    import time

    from slurm_bridge_tpu_torch.bridge.objects import Pod, PodPhase
    from slurm_bridge_tpu_torch.bridge.operator import sizecar_name
    from slurm_bridge_tpu_torch.solver import AuctionConfig

    def phase(name):
        try:
            p = bridge.store.get(Pod.KIND, sizecar_name(name))
            return p.status.phase, p.status.reason
        except Exception:  # noqa: BLE001 — NotFound early in the walk
            return PodPhase.PENDING, "(no pod yet)"

    def wait_for(pred, what, timeout=30.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred():
                return True
            time.sleep(0.05)
        print(f"TIMEOUT waiting for {what}")
        return False

    with Bridge(
        sock,
        scheduler_backend="auction",
        auction_config=AuctionConfig(rounds=4),
        preemption=True,
        scheduler_interval=0.05,
        node_sync_interval=0.05,
    ) as bridge:
        print("== 1. low-priority job saturates the one 4-cpu node ==")
        bridge.submit("low", BridgeJobSpec(
            partition="tiny", cpus_per_task=4, priority=1,
            sbatch_script="#!/bin/sh\nsleep 30\n",
        ))
        if not wait_for(lambda: phase("low")[0] == PodPhase.RUNNING, "low RUNNING"):
            return 1
        print("   low: RUNNING (priority 1, 4/4 cpus)")

        print("== 2. high-priority job arrives; no free capacity ==")
        bridge.submit("high", BridgeJobSpec(
            partition="tiny", cpus_per_task=4, priority=9,
            sbatch_script="#!/bin/sh\necho important\n",
        ))
        if not wait_for(
            lambda: "Preempted" in phase("low")[1]
            or phase("low")[0] == PodPhase.PENDING,
            "low preempted",
        ):
            return 1
        print(f"   low: preempted — its Slurm job cancelled, pod requeued"
              f" (reason: {phase('low')[1]!r})")

        print("== 3. high runs in the freed capacity ==")
        job = bridge.wait("high", timeout=30)
        print(f"   high: {job.status.state} (priority 9 won the node)")

        print("== 4. low re-places once high finishes ==")
        if not wait_for(
            lambda: phase("low")[0] == PodPhase.RUNNING, "low re-placed",
            timeout=60.0,
        ):
            return 1
        print("   low: RUNNING again (re-submitted under a fresh dedupe "
              "generation)")
        ok = job.status.state == "Succeeded"
    print("preemption demo", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
