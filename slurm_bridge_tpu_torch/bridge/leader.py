"""Leader election — single active operator via a lease file.

Reference parity: the operator's controller-runtime leader election
(cmd/bridge-operator/bridge-operator.go:59-61,75-76), which rides a K8s
Lease object: candidates try to acquire a named lease, the holder renews it
on an interval, and a candidate may take over once the holder's lease
expires (crash recovery without fencing the filesystem). Here the lease is
a JSON file updated by atomic rename, giving the same
acquire/renew/expire/release state machine for co-located processes —
the deployment story the reference's election actually protects (two
operator replicas pointed at the same control plane).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
import uuid

from slurm_bridge_tpu_torch.utils.files import atomic_write

log = logging.getLogger("sbt.leader")


def default_identity() -> str:
    return f"{socket.gethostname()}_{os.getpid()}_{uuid.uuid4().hex[:8]}"


class LeaderElector:
    """Acquire-and-renew loop over a lease file.

    ``run()`` blocks until leadership is acquired, fires ``on_started``,
    then renews every ``renew_interval`` seconds; if a renewal discovers the
    lease stolen (or renewal keeps failing past the lease duration),
    ``on_stopped`` fires — the caller should exit, as the reference's
    manager does when it loses the lease.
    """

    def __init__(
        self,
        lock_path: str,
        *,
        identity: str | None = None,
        lease_duration: float = 15.0,
        renew_interval: float = 5.0,
        retry_interval: float = 2.0,
        on_started=None,
        on_stopped=None,
        clock=time.time,
    ):
        self.lock_path = lock_path
        self.identity = identity or default_identity()
        #: injectable time source — the simulator passes its virtual
        #: clock so lease expiry is deterministic (no sleeps); production
        #: keeps wall time
        self._clock = clock
        self.lease_duration = lease_duration
        self.renew_interval = renew_interval
        self.retry_interval = retry_interval
        self.on_started = on_started
        self.on_stopped = on_stopped
        self._stop = threading.Event()
        self._leading = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lease file primitives -------------------------------------------
    def _read(self) -> dict | None:
        try:
            with open(self.lock_path) as fh:
                return json.load(fh)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def _write(self, record: dict) -> None:
        atomic_write(self.lock_path, json.dumps(record))

    def try_acquire(self) -> bool:
        """One acquire-or-renew attempt. True if we hold the lease after it.

        The read-check-write runs under an flock on a sidecar ``.flock``
        file, so two candidates racing on an expired lease serialize and
        exactly one observes itself as holder (no split-brain window).
        """
        import fcntl

        d = os.path.dirname(self.lock_path) or "."
        os.makedirs(d, exist_ok=True)
        guard = os.open(self.lock_path + ".flock", os.O_CREAT | os.O_RDWR, 0o644)
        try:
            fcntl.flock(guard, fcntl.LOCK_EX)
            now = self._clock()
            rec = self._read()
            if rec is not None and rec.get("holder") != self.identity:
                if now < float(rec.get("expires", 0)):
                    return False  # someone else holds a live lease
                log.info("lease %s expired (holder=%s); taking over",
                         self.lock_path, rec.get("holder"))
            renewing = rec is not None and rec.get("holder") == self.identity
            self._write({
                "holder": self.identity,
                "acquired": rec.get("acquired", now) if renewing else now,
                "renewed": now,
                "expires": now + self.lease_duration,
            })
            return True
        finally:
            os.close(guard)  # closing drops the flock

    def release(self) -> None:
        """Delete our lease, under the same flock as try_acquire so a
        rival's in-flight takeover cannot be unlinked by our stale read."""
        import fcntl

        try:
            guard = os.open(self.lock_path + ".flock", os.O_CREAT | os.O_RDWR, 0o644)
        except OSError:
            return
        try:
            fcntl.flock(guard, fcntl.LOCK_EX)
            rec = self._read()
            if rec and rec.get("holder") == self.identity:
                try:
                    os.unlink(self.lock_path)
                except OSError:
                    pass
        finally:
            os.close(guard)

    # -- loop -------------------------------------------------------------
    @property
    def is_leader(self) -> bool:
        return self._leading.is_set()

    def run(self) -> None:
        """Blocking acquire → renew loop (call in a thread via start())."""
        acquired_at = 0.0
        while not self._stop.is_set():
            try:
                # pre-request stamp, for the same reason as the renewal
                # loop below: expiry must be measured from what rivals see
                acquired_at = self._clock()
                if self.try_acquire():
                    break
            except OSError as exc:
                log.warning("lease acquire error (retrying): %s", exc)
            if self._stop.wait(self.retry_interval):
                return
        if self._stop.is_set():
            return
        self._leading.set()
        log.info("became leader (%s) on %s", self.identity, self.lock_path)
        if self.on_started:
            self.on_started()
        deadline = acquired_at + self.lease_duration
        while not self._stop.wait(self.renew_interval):
            if self._clock() > deadline:
                # check BEFORE attempting: a slow failing attempt must not
                # extend how long a stale holder keeps acting past expiry
                log.error("lease expired before renewal could complete")
                break
            try:
                # stamp from BEFORE the renewal request: rivals compute
                # expiry from the renewTime written inside try_acquire, so
                # a post-return stamp would let a stale holder act up to
                # ~2×request_timeout past the takeover (ADVICE r4) —
                # client-go's leaderelection does the same
                t0 = self._clock()
                if self.try_acquire():
                    deadline = t0 + self.lease_duration
                    continue
                log.warning("lease stolen; stepping down")
                break
            except OSError as exc:
                if self._clock() > deadline:
                    log.error("lease renewal failing past deadline: %s", exc)
                    break
                log.warning("lease renewal error (retrying): %s", exc)
        was_leading = self._leading.is_set()
        self._leading.clear()
        if was_leading and self.on_stopped:
            self.on_stopped()

    def start(self) -> "LeaderElector":
        self._thread = threading.Thread(target=self.run, name="leader-elector", daemon=True)
        self._thread.start()
        return self

    def wait_until_leader(self, timeout: float | None = None) -> bool:
        return self._leading.wait(timeout)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(5.0)
        self.release()


# ---------------------------------------------------------------- K8s Lease


def _micro_time(t: float) -> str:
    """K8s MicroTime rendering (2026-07-30T12:00:00.000000Z). Truncates the
    fraction — rounding could carry to a 7-digit fraction, which RFC3339Micro
    rejects."""
    return time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(t)) + (
        ".%06dZ" % min(int((t % 1.0) * 1e6), 999_999)
    )


def _parse_k8s_time(s: str) -> float | None:
    """Parse RFC3339 with or without fractional seconds; None on garbage."""
    if not s:
        return None
    base, frac = s.rstrip("Z"), 0.0
    if "." in base:
        base, frac_s = base.split(".", 1)
        try:
            frac = float("0." + frac_s)
        except ValueError:
            frac = 0.0
    try:
        import calendar

        return calendar.timegm(time.strptime(base, "%Y-%m-%dT%H:%M:%S")) + frac
    except ValueError:
        return None


class KubeLeaseElector(LeaderElector):
    """The file elector's state machine over a coordination.k8s.io/v1 Lease.

    This is the reference's actual election primitive (controller-runtime's
    Lease election, cmd/bridge-operator/bridge-operator.go:59-61,75-76) and
    — unlike the file lease — arbitrates replicas on *different hosts*: two
    ``sbt-bridge --kube-api`` instances race on one named Lease object, the
    holder renews ``renewTime``, and a candidate takes over once
    ``renewTime + leaseDurationSeconds`` passes. Optimistic concurrency via
    ``metadata.resourceVersion`` (a lost PUT race returns 409 ⇒ not
    leader); ``release()`` clears ``holderIdentity`` so a clean shutdown
    hands over immediately instead of waiting out the lease.
    """

    def __init__(self, config, lease_name: str = "slurm-bridge-operator", **kwargs):
        super().__init__(
            lock_path=f"lease:{config.namespace}/{lease_name}", **kwargs
        )
        self.config = config
        self.lease_name = lease_name
        #: per-request deadline MUST be well under the lease duration: with
        #: the default 30 s HTTP timeout, a hung apiserver stalls a renewal
        #: past expiry and the stale holder keeps acting while a rival on
        #: the healthy side takes over — a split-brain window. /6 because a
        #: renewal attempt issues up to TWO sequential requests (GET + PUT)
        #: and run() also gates each attempt on the expiry deadline, so the
        #: worst-case overrun is bounded by one attempt (~lease/3), not a
        #: full extra lease duration
        self.request_timeout = max(0.5, min(self.lease_duration / 6.0, 10.0))

    # -- REST primitives --

    def _path(self, name: bool = True) -> str:
        p = (
            "/apis/coordination.k8s.io/v1/namespaces/"
            f"{self.config.namespace}/leases"
        )
        return f"{p}/{self.lease_name}" if name else p

    def _get(self) -> dict | None:
        """The Lease object, or None on 404. Other failures raise OSError
        (run() treats them as retryable)."""
        import json as _json
        import urllib.error

        try:
            with self.config.open(
                self._path(), timeout=self.request_timeout
            ) as resp:
                return _json.load(resp)
        except urllib.error.HTTPError as exc:
            if exc.code == 404:
                return None
            raise
        except _json.JSONDecodeError as exc:
            raise OSError(f"malformed Lease body: {exc}") from exc

    def _send(self, method: str, path: str, body: dict) -> bool:
        """POST/PUT the lease; False on a lost 409 race, True on success."""
        import json as _json
        import urllib.error

        try:
            with self.config.open(
                path,
                method=method,
                body=_json.dumps(body).encode(),
                content_type="application/json",
                timeout=self.request_timeout,
            ):
                return True
        except urllib.error.HTTPError as exc:
            if exc.code == 409:
                return False
            raise

    # -- the two primitives the state machine needs --

    def try_acquire(self) -> bool:
        now = self._clock()
        obj = self._get()
        if obj is None:
            return self._send(
                "POST",
                self._path(name=False),
                {
                    "apiVersion": "coordination.k8s.io/v1",
                    "kind": "Lease",
                    "metadata": {"name": self.lease_name},
                    "spec": self._spec(now, acquire=True, transitions=0),
                },
            )
        spec = obj.get("spec") or {}
        holder = spec.get("holderIdentity") or ""
        transitions = int(spec.get("leaseTransitions") or 0)
        taking_over = False
        if holder and holder != self.identity:
            raw_duration = spec.get("leaseDurationSeconds")
            duration = (
                float(raw_duration)
                if raw_duration is not None
                else self.lease_duration
            )
            renewed = _parse_k8s_time(
                spec.get("renewTime") or spec.get("acquireTime") or ""
            )
            if renewed is not None and now < renewed + duration:
                return False  # live holder elsewhere
            log.info(
                "lease %s expired (holder=%s); taking over",
                self.lease_name, holder,
            )
            taking_over = True
        elif not holder:
            taking_over = True  # released lease: adopt without waiting
        obj["spec"] = self._spec(
            now,
            acquire=taking_over,
            transitions=transitions + (1 if taking_over else 0),
            acquired=spec.get("acquireTime"),
        )
        return self._send("PUT", self._path(), obj)

    def _spec(
        self,
        now: float,
        *,
        acquire: bool,
        transitions: int,
        acquired: str | None = None,
    ) -> dict:
        return {
            "holderIdentity": self.identity,
            # at least 1: a serialized 0 would read back as "instantly
            # expired" for rivals (sub-second durations exist only in tests)
            "leaseDurationSeconds": max(1, int(self.lease_duration)),
            "acquireTime": _micro_time(now) if acquire or not acquired else acquired,
            "renewTime": _micro_time(now),
            "leaseTransitions": transitions,
        }

    def release(self) -> None:
        """Clear holderIdentity so a standby takes over immediately."""
        try:
            obj = self._get()
        except OSError:
            return
        if obj is None:
            return
        spec = obj.get("spec") or {}
        if spec.get("holderIdentity") != self.identity:
            return
        spec["holderIdentity"] = ""
        obj["spec"] = spec
        try:
            self._send("PUT", self._path(), obj)
        except OSError:
            pass  # best-effort: the lease simply expires instead
