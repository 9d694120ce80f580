"""Per-replica solver sidecar supervisor.

Spawn -> JSON ready handshake -> Healthz schema check -> serve. On any
failure the supervisor *remembers* the sidecar is down (colpool's
remembered-fallback pattern: one loud log, then silent inline solves, no
per-shard retry storm) and re-spawns with a backoff measured in ticks so
virtual time, not wall time, paces recovery. A Healthz whose
``schema_version`` disagrees with ours is REFUSED — a version-skewed
sidecar must fail at adoption, loudly, not mid-solve.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys

log = logging.getLogger("sbt.fleet.sidecar")


class SidecarSupervisor:
    """Owns one solver sidecar process for one bridge replica."""

    def __init__(
        self,
        replica_id: str,
        state_dir: str,
        *,
        startup_timeout_s: float = 60.0,
        restart_backoff_ticks: int = 2,
    ):
        self.replica_id = replica_id
        self.endpoint = os.path.join(state_dir, f"{replica_id}.sock")
        self.startup_timeout_s = startup_timeout_s
        self.restart_backoff_ticks = restart_backoff_ticks
        self.proc: subprocess.Popen | None = None
        self.client = None
        self.incarnation = ""
        self.down = False
        self.down_since_tick = -1
        self.down_reason = ""
        self.spawn_count = 0
        self.restart_count = 0

    # ---- lifecycle ----

    def spawn(self, shard_set: tuple[int, ...] = ()) -> bool:
        """Start a fresh sidecar and adopt it. Returns True on success;
        on failure the supervisor is left in remembered-down state."""
        self._reap()
        if os.path.exists(self.endpoint):
            os.unlink(self.endpoint)
        self.spawn_count += 1
        incarnation = f"{self.replica_id}.{self.spawn_count}"
        cmd = [
            sys.executable, "-m", "slurm_bridge_tpu_torch.fleet.worker",
            "--listen", self.endpoint,
            "--replica-id", self.replica_id,
            "--incarnation", incarnation,
            "--shards", ",".join(str(s) for s in shard_set),
        ]
        env = {**os.environ, "SBT_BACKEND": "cpu"}
        try:
            self.proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env,
            )
        except OSError as exc:
            return self._adopt_failed(f"spawn: {exc}")
        self._relay_stderr(self.proc)
        try:
            ready = self._read_ready_line()
        except Exception as exc:  # noqa: BLE001 - any handshake failure
            return self._adopt_failed(f"handshake: {exc}")
        if not ready:
            return self._adopt_failed("worker exited before ready line")
        return self._adopt(incarnation)

    def _relay_stderr(self, proc: subprocess.Popen) -> None:
        """Relay the sidecar's stderr to ours, each line prefixed with the
        replica id (ISSUE 20 log correlation): the sidecar's own log lines
        already carry trace_id/span_id via the obs/logging formatters, and
        the prefix names WHICH process they came from. Daemon thread; ends
        when the child closes the pipe."""
        import threading

        stderr = proc.stderr
        if stderr is None:
            return
        prefix = f"[{self.replica_id}] "

        def relay() -> None:
            try:
                for line in stderr:
                    sys.stderr.write(prefix + line)
            except (ValueError, OSError):
                pass  # pipe closed mid-read during teardown

        threading.Thread(
            target=relay, name=f"sidecar-stderr-{self.replica_id}", daemon=True
        ).start()

    def _read_ready_line(self) -> dict | None:
        import threading

        assert self.proc is not None and self.proc.stdout is not None
        # readline on a crashed worker returns "" (stdout closed); the
        # timer only fires if the worker hangs before binding
        timer = threading.Timer(self.startup_timeout_s, self.proc.kill)
        timer.start()
        try:
            line = self.proc.stdout.readline()
        finally:
            timer.cancel()
        if not line:
            return None
        return json.loads(line)

    def _adopt(self, incarnation: str) -> bool:
        from slurm_bridge_tpu_torch.fleet.columnar import schema_digest
        from slurm_bridge_tpu_torch.wire import messages as pb
        from slurm_bridge_tpu_torch.wire.rpc import ServiceClient, dial

        client = ServiceClient(
            dial(self.endpoint), "PlacementSolver", retry=None
        )
        try:
            hz = client.Healthz(pb.HealthzRequest(), timeout=self.startup_timeout_s)
        except Exception as exc:  # noqa: BLE001
            return self._adopt_failed(f"healthz probe: {exc}")
        if hz.schema_version != schema_digest():
            # version skew: refuse, don't adopt — the opaque alternative
            # is a mid-tick decode mismatch
            self.kill()
            return self._adopt_failed(
                f"schema skew: sidecar={hz.schema_version} "
                f"ours={schema_digest()}"
            )
        self.client = client
        self.incarnation = incarnation
        self.down = False
        self.down_reason = ""
        return True

    def _adopt_failed(self, reason: str) -> bool:
        log.warning("sidecar %s adoption failed: %s (solving inline)",
                    self.replica_id, reason)
        self.client = None
        self.down = True
        self.down_reason = reason
        return False

    # ---- health ----

    def poll_alive(self) -> bool:
        """Cheap liveness: the OS process is still running and adopted."""
        return (
            not self.down
            and self.proc is not None
            and self.proc.poll() is None
        )

    def mark_down(self, tick: int, reason: str) -> None:
        """Remembered fallback: one transition, logged once."""
        if self.down:
            return
        log.warning("sidecar %s down at tick %d: %s (solving inline)",
                    self.replica_id, tick, reason)
        self.down = True
        self.down_since_tick = tick
        self.down_reason = reason
        self.client = None

    def maybe_restart(self, tick: int, shard_set: tuple[int, ...] = ()) -> bool:
        """Re-spawn after the backoff elapses (in ticks, i.e. virtual
        time). Returns True when the sidecar was re-adopted."""
        if not self.down:
            return False
        if tick - self.down_since_tick < self.restart_backoff_ticks:
            return False
        self._reap()
        if self.spawn(shard_set):
            self.restart_count += 1
            log.info("sidecar %s re-adopted at tick %d (incarnation %s)",
                     self.replica_id, tick, self.incarnation)
            return True
        self.down_since_tick = tick  # failed again: restart the backoff
        return False

    # ---- teardown ----

    def kill(self) -> None:
        """SIGKILL + wait: synchronous, so death is observed immediately
        and deterministically (the chaos fault relies on this)."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self._close_client()

    def stop(self) -> None:
        """Graceful shutdown for teardown paths."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)
        self._close_client()
        self._reap()

    def _close_client(self) -> None:
        if self.client is not None:
            try:
                self.client.close()
            except Exception:  # noqa: BLE001
                pass
        self.client = None

    def _reap(self) -> None:
        if self.proc is not None:
            if self.proc.poll() is None:
                return
            if self.proc.stdout is not None:
                self.proc.stdout.close()
            if self.proc.stderr is not None:
                self.proc.stderr.close()
            self.proc = None
