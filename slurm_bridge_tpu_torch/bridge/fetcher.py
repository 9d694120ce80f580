"""Result fetcher — stream job artifacts from the login node to disk.

Reference parity: cmd/result-fetcher/result-fetcher.go:23-90 (the one-shot
``--from/--to/--endpoint`` CLI, kept as ``python -m
slurm_bridge_tpu_torch.bridge.fetcher``) and the operator-created batch Job that
runs one fetch container per sub-job (result.go:45-65). The in-process
:class:`FetchWorker` plays the batch-Job executor: it watches FetchJob
objects and runs their transfers with backoff-limit-0 semantics (any file
failing fails the job, result.go:26).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import threading

from slurm_bridge_tpu_torch.bridge.objects import FetchJob, FetchState
from slurm_bridge_tpu_torch.bridge.store import NotFound, ObjectStore
from slurm_bridge_tpu_torch.wire import RpcError, ServiceClient, dial, pb

log = logging.getLogger("sbt.fetcher")


def fetch_file(client: ServiceClient, remote_path: str, local_path: str) -> int:
    """OpenFile stream → local file; returns bytes written
    (result-fetcher.go:55-86)."""
    os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
    written = 0
    tmp = f"{local_path}.partial"
    with open(tmp, "wb") as out:
        for chunk in client.OpenFile(pb.OpenFileRequest(path=remote_path)):
            out.write(chunk.content)
            written += len(chunk.content)
    os.replace(tmp, local_path)
    return written


class FetchWorker:
    """Executes pending FetchJobs from the store."""

    def __init__(self, store: ObjectStore, client: ServiceClient):
        self.store = store
        self.client = client
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "FetchWorker":
        self._watch_q = self.store.watch((FetchJob.KIND,))
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._watch_q.put(None)
        self._thread.join(5.0)

    def _run(self) -> None:
        while not self._stop.is_set():
            ev = self._watch_q.get()
            if ev is None:
                return
            if ev.type == "DELETED":
                continue
            try:
                self.run_one(ev.name)
            except NotFound:
                continue
            except Exception:
                log.exception("fetch job %s failed", ev.name)

    def run_one(self, name: str) -> None:
        fetch: FetchJob = self.store.get(FetchJob.KIND, name)
        if fetch.state not in (FetchState.PENDING,):
            return

        def claim(f: FetchJob):
            if f.state != FetchState.PENDING:
                return False
            f.state = FetchState.RUNNING

        claimed = self.store.mutate(FetchJob.KIND, name, claim)
        if claimed.state != FetchState.RUNNING:
            return

        # private copy: the claimed snapshot is frozen, and the transfer
        # loop below checks files off in place
        files = [dataclasses.replace(f) for f in claimed.files]
        failure = ""
        for f in files:
            if f.done:
                continue
            try:
                n = fetch_file(self.client, f.remote_path, f.local_path)
                f.done = True
                log.info("fetched %s -> %s (%d bytes)", f.remote_path, f.local_path, n)
            except (RpcError, OSError) as e:
                detail = e.details() if isinstance(e, RpcError) else str(e)
                f.error = detail
                failure = f"{f.remote_path}: {detail}"
                break  # backoffLimit 0: first failure fails the job

        def finish(fj: FetchJob):
            fj.files = files
            fj.state = FetchState.FAILED if failure else FetchState.SUCCEEDED
            fj.reason = failure

        self.store.mutate(FetchJob.KIND, name, finish)


def main(argv: list[str] | None = None) -> int:
    """The standalone one-shot fetcher (result-fetcher.go:23-90)."""
    ap = argparse.ArgumentParser(prog="sbt-result-fetcher")
    ap.add_argument("--from", dest="src", required=True, help="remote file path")
    ap.add_argument("--to", dest="dst", required=True, help="local destination path")
    ap.add_argument("--endpoint", required=True, help="agent endpoint (host:port or *.sock)")
    args = ap.parse_args(argv)
    with ServiceClient(dial(args.endpoint), "WorkloadManager") as client:
        try:
            n = fetch_file(client, args.src, args.dst)
        except RpcError as e:
            print(f"fetch failed: {e.details()}", file=sys.stderr)
            return 1
    print(f"fetched {n} bytes -> {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
