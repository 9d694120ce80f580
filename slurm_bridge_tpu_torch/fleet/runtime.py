"""FleetRuntime: replica membership + sidecar fleet + the remote seam.

Plugs into ``ShardExecutor.remote``: when attached, per-shard solves are
dispatched to the shard's *owning* replica's solver sidecar over real
gRPC (columnar framing, byte-parity with inline by construction — see
``columnar.py``). The membership table keys shard -> replica
deterministically from the live set, so killing a shard-owner re-keys
its shard-set to survivors on the next heartbeat; the returned
``free_after`` is exactly what ``ShardExecutor._merge_traced`` already
gossips into the leader's cross-shard reconcile residual.

Two stats surfaces, deliberately split:

- ``stats()``    — deterministic membership facts (replica count, rekeys,
  lease expiries, kills, recovery ticks). Safe to byte-compare in the
  sim's determinism dict.
- ``remote_stats()`` — volatile transport counters (remote solves, inline
  fallbacks, restarts). These depend on OS scheduling and ride the
  quality section (``policy_extra``) instead; the fleet smoke gates
  ``remote_solves > 0`` explicitly so a silently-inline run fails loudly.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass

from slurm_bridge_tpu_torch.obs.metrics import REGISTRY

log = logging.getLogger("sbt.fleet")

_replicas_live = REGISTRY.gauge(
    "sbt_fleet_replicas_live", "bridge replicas with a live membership lease"
)
_rekeys_total = REGISTRY.counter(
    "sbt_fleet_rekeys_total", "shard-set re-keys (live membership changes)"
)
_remote_solves_total = REGISTRY.counter(
    "sbt_fleet_remote_solves_total", "per-shard solves dispatched to sidecars"
)
_inline_fallbacks_total = REGISTRY.counter(
    "sbt_fleet_inline_fallbacks_total",
    "per-shard solves that fell back inline (sidecar down or RPC failed)",
)
_sidecar_restarts_total = REGISTRY.counter(
    "sbt_fleet_sidecar_restarts_total", "sidecar processes re-spawned"
)
_gossip_staleness = REGISTRY.gauge(
    "sbt_fleet_gossip_staleness_ticks",
    "ticks since a remote solve last gossiped a residual back",
)


#: process-wide registry of live FleetRuntimes — what /debug/fleetz
#: renders (the SCHEDZ pattern: the page is mounted once by
#: obs.bootstrap; runtimes register on construction, drop on close)
_ACTIVE: list["FleetRuntime"] = []
_ACTIVE_LOCK = threading.Lock()


def render_fleetz() -> str:
    """Text body for the /debug/fleetz zpage."""
    with _ACTIVE_LOCK:
        runtimes = list(_ACTIVE)
    if not runtimes:
        return "fleetz — no fleet runtime active in this process\n"
    return "\n".join(rt.fleetz() for rt in runtimes)


# ---- trace stitching (ISSUE 20) -------------------------------------------

def stitch_place_shard(span, resp) -> None:
    """Materialize the sidecar's timing summary as synthetic child spans
    under the OPEN ``rpc.client.PlaceShard`` span: ``sidecar.decode`` /
    ``sidecar.solve`` / ``sidecar.encode`` carry the worker-measured ns,
    and everything left of the client-observed wall time becomes a NAMED
    ``rpc.overhead`` residual (serialization, the unix socket, gRPC
    threading) instead of unattributed parent self-time."""
    total_ns = int(resp.decode_ns) + int(resp.solve_ns) + int(resp.encode_ns)
    if total_ns <= 0:
        return  # pre-ISSUE-20 sidecar: no summary, nothing to stitch
    from slurm_bridge_tpu_torch.obs.tracing import TRACER

    elapsed_s = span.duration  # still open: monotonic now − span start
    offset = 0.0
    for name, ns in (
        ("sidecar.decode", int(resp.decode_ns)),
        ("sidecar.solve", int(resp.solve_ns)),
        ("sidecar.encode", int(resp.encode_ns)),
    ):
        counters = {"rows": float(resp.rows)} if name == "sidecar.solve" else None
        TRACER.emit_synthetic(
            name, parent=span, duration_s=ns / 1e9,
            start_offset_s=offset, counters=counters,
        )
        offset += ns / 1e9
    TRACER.emit_synthetic(
        "rpc.overhead", parent=span,
        duration_s=max(0.0, elapsed_s - offset), start_offset_s=offset,
    )


_stitch_refs = 0
_stitch_lock = threading.Lock()


def _stitching(enable: bool) -> None:
    """Refcounted registration of the PlaceShard client-span hook — the
    hook is process-wide (wire/rpc.py), runtimes come and go per run."""
    global _stitch_refs
    from slurm_bridge_tpu_torch.wire.rpc import set_client_span_hook

    with _stitch_lock:
        if enable:
            _stitch_refs += 1
            if _stitch_refs == 1:
                set_client_span_hook("PlaceShard", stitch_place_shard)
        else:
            _stitch_refs = max(0, _stitch_refs - 1)
            if _stitch_refs == 0:
                set_client_span_hook("PlaceShard", None)


# ---- metrics federation + lifecycle timeline (ISSUE 20) -------------------

class _FleetReplicaCollector:
    """Scrape-time bridge view of the sidecars' counter totals: every
    federated sidecar counter renders as
    ``sbt_fleet_replica_<suffix>{replica="..."}`` (suffix = the sidecar's
    counter name with its ``sbt_`` prefix stripped). Source of truth is
    the per-runtime snapshot the heartbeat refreshed last tick — the
    scrape itself costs no RPC."""

    name = "sbt_fleet_replica"

    def collect(self) -> list[str]:
        with _ACTIVE_LOCK:
            runtimes = list(_ACTIVE)
        lines: list[str] = []
        typed: set[str] = set()
        for rt in runtimes:
            for rid, snap in sorted(rt.federated().items()):
                for cname in sorted(snap):
                    suffix = cname[4:] if cname.startswith("sbt_") else cname
                    fname = f"sbt_fleet_replica_{suffix}"
                    if fname not in typed:
                        lines.append(f"# TYPE {fname} counter")
                        typed.add(fname)
                    lines.append(f'{fname}{{replica="{rid}"}} {snap[cname]}')
        return lines


REGISTRY.register(_FleetReplicaCollector())


def render_timeline(events: list[dict], limit: int = 0) -> str:
    """Human-readable fleet lifecycle timeline (fleetz + scenario JSON
    consumers). ``events`` is the structured list a FleetRuntime
    accumulates — it round-trips through the flight record's ``fleet``
    section, so this renders equally from a live runtime or a loaded
    artifact. tick -1 marks startup, before the first heartbeat."""
    shown = events[-limit:] if limit else events
    lines = []
    for ev in shown:
        tick = ev.get("tick", -1)
        where = "startup" if tick < 0 else f"tick {tick:>4}"
        line = f"  {where}  {ev.get('event', '?'):<8} {ev.get('replica', '') or '-':<12}"
        if ev.get("detail"):
            line += f" {ev['detail']}"
        lines.append(line)
    return "\n".join(lines)


@dataclass(frozen=True)
class FleetConfig:
    """Fleet topology + lease tuning; rides ``Scenario.fleet``."""

    replicas: int = 1
    lease_duration_s: float = 12.0
    restart_backoff_ticks: int = 2
    startup_timeout_s: float = 60.0


class FleetRuntime:
    """Owns the membership table, the sidecar fleet, and the leader lease."""

    def __init__(
        self,
        config: FleetConfig,
        state_dir: str,
        *,
        clock=time.time,
        obs: bool = True,
    ):
        import os

        from slurm_bridge_tpu_torch.bridge.leader import LeaderElector
        from slurm_bridge_tpu_torch.fleet.membership import MembershipTable
        from slurm_bridge_tpu_torch.fleet.sidecar import SidecarSupervisor

        self.config = config
        self.state_dir = state_dir
        self.clock = clock
        self.membership = MembershipTable(
            os.path.join(state_dir, "membership.json"),
            lease_duration=config.lease_duration_s,
            clock=clock,
        )
        self.supervisors = {
            f"replica-{i}": SidecarSupervisor(
                f"replica-{i}", state_dir,
                startup_timeout_s=config.startup_timeout_s,
                restart_backoff_ticks=config.restart_backoff_ticks,
            )
            for i in range(config.replicas)
        }
        self.leader = LeaderElector(
            os.path.join(state_dir, "fleet-leader.lease"),
            identity="replica-0",
            lease_duration=config.lease_duration_s,
            clock=clock,
        )
        self._lock = threading.Lock()
        self._remote_solves = 0
        self._inline_fallbacks = 0
        self._last_remote_tick = -1
        self._tick = 0
        self.kills = 0
        self.rekey_ticks: list[int] = []
        self.recovery_ticks = 0
        self._pending_rekey_from = -1
        self._last_live: tuple[str, ...] = ()
        self._is_leader = False
        #: fleet observability (ISSUE 20): trace stitching + per-tick
        #: Healthz federation + the lifecycle timeline. Volatile-only —
        #: nothing here enters the determinism digests, so the paired
        #: profile_fleet_obs_overhead arms are byte-identical.
        self.obs = obs
        self.events: list[dict] = []
        self._federated: dict[str, dict[str, float]] = {}
        if obs:
            _stitching(True)
        self._closed = False
        with _ACTIVE_LOCK:
            _ACTIVE.append(self)

    def _record(self, tick: int, event: str, replica: str = "", detail: str = "") -> None:
        if not self.obs:
            return
        if len(self.events) >= 4096:  # runaway-chaos backstop
            del self.events[:1024]
        self.events.append(
            {"tick": tick, "event": event, "replica": replica, "detail": detail}
        )

    # ---- lifecycle ----

    def start(self) -> None:
        self._is_leader = self.leader.try_acquire()
        for rid, sup in sorted(self.supervisors.items()):
            self._record(-1, "spawn", rid)
            if sup.spawn():
                self.membership.join(rid, sup.incarnation, sup.endpoint)
                self._record(-1, "ready", rid, f"incarnation={sup.incarnation}")
            else:
                self.membership.mark_dead(rid, reason=sup.down_reason)
                self._record(-1, "dead", rid, sup.down_reason)
        self._last_live = tuple(self.membership.live())
        _replicas_live.set(len(self._last_live))
        if not self._last_live:
            log.warning("fleet started with zero live replicas: all solves inline")

    def heartbeat(self, tick: int) -> None:
        """Per-tick membership maintenance: renew live leases, detect dead
        sidecars, restart after backoff, expire lapsed leases, re-key."""
        self._tick = tick
        self._is_leader = self.leader.try_acquire()
        for rid, sup in sorted(self.supervisors.items()):
            if sup.poll_alive():
                self.membership.renew(rid)
            else:
                if not sup.down:
                    sup.mark_down(tick, "process exited")
                    self.membership.mark_dead(rid, reason="process exited")
                    self._record(tick, "dead", rid, "process exited")
                    self._record(
                        tick, "backoff", rid,
                        f"restart eligible at tick "
                        f"{tick + sup.restart_backoff_ticks}",
                    )
                if sup.maybe_restart(tick):
                    _sidecar_restarts_total.inc()
                    self.membership.join(rid, sup.incarnation, sup.endpoint)
                    self._record(
                        tick, "restart", rid, f"incarnation={sup.incarnation}"
                    )
        for rid in self.membership.expire():
            sup = self.supervisors.get(rid)
            if sup is not None and not sup.down:
                sup.mark_down(tick, "lease expired")
            self._record(tick, "expire", rid)
        live = tuple(self.membership.live())
        if live != self._last_live:
            self.rekey_ticks.append(tick)
            _rekeys_total.inc()
            self._record(tick, "rekey", detail=f"live={list(live)}")
            if len(live) < len(self._last_live) and self._pending_rekey_from < 0:
                self._pending_rekey_from = tick
            elif len(live) >= len(self._last_live) and self._pending_rekey_from >= 0:
                self.recovery_ticks = max(
                    self.recovery_ticks, tick - self._pending_rekey_from
                )
                self._pending_rekey_from = -1
            log.info("fleet re-key at tick %d: live=%s", tick, list(live))
            self._last_live = live
        _replicas_live.set(len(live))
        if self._last_remote_tick >= 0:
            _gossip_staleness.set(tick - self._last_remote_tick)
        if self.obs:
            self._federate()

    def _federate(self) -> None:
        """Pull each live sidecar's counter totals over Healthz and keep
        the latest snapshot per replica (served from the bridge scrape by
        ``_FleetReplicaCollector``). Best-effort: a failed probe keeps the
        previous snapshot — liveness policy stays with poll_alive/
        PlaceShard, federation must never mark anything down."""
        from slurm_bridge_tpu_torch.wire import messages as pb

        for rid, sup in sorted(self.supervisors.items()):
            if sup.down or sup.client is None:
                continue
            try:
                hz = sup.client.Healthz(pb.HealthzRequest(), timeout=5.0)
            except Exception:  # noqa: BLE001 - next heartbeat retries
                continue
            if not hz.metric_name:
                continue  # pre-ISSUE-20 sidecar
            snap = dict(zip(hz.metric_name, hz.metric_total))
            with self._lock:
                self._federated[rid] = snap

    def kill_replica(self, rid: str) -> None:
        """Chaos hook: SIGKILL the replica's sidecar, synchronously, so the
        next heartbeat observes the death deterministically."""
        sup = self.supervisors.get(rid)
        if sup is None:
            return
        self.kills += 1
        sup.kill()
        self._record(self._tick, "kill", rid, "chaos: SIGKILL")
        log.info("fleet chaos: killed %s (sidecar pid reaped)", rid)

    def close(self) -> None:
        with _ACTIVE_LOCK:
            if self in _ACTIVE:
                _ACTIVE.remove(self)
        if self.obs and not self._closed:
            _stitching(False)
        self._closed = True
        for sup in self.supervisors.values():
            sup.stop()
        self.leader.release()

    # ---- the remote seam ----

    def try_solve(self, sid, engine, policy, snapshot, batch, incumbent):
        """Dispatch one shard solve to its owner's sidecar. Returns the
        Placement, or None -> caller solves inline (remembered fallback:
        the owner is marked down + dead, so subsequent shards skip the
        RPC entirely until restart re-adopts it)."""
        # observed shard-space size, for the fleetz ownership rendering
        if sid >= getattr(self, "num_shards", 0):
            self.num_shards = sid + 1
        owner = self.membership.owner_of(sid)
        sup = self.supervisors.get(owner) if owner else None
        if sup is None or sup.client is None:
            with self._lock:
                self._inline_fallbacks += 1
            _inline_fallbacks_total.inc()
            return None
        from slurm_bridge_tpu_torch.fleet.columnar import (
            encode_place_shard,
            placement_from_response,
        )

        request = encode_place_shard(sid, engine, policy, snapshot, batch, incumbent)
        try:
            resp = sup.client.PlaceShard(request, timeout=self.config.startup_timeout_s)
        except Exception as exc:  # noqa: BLE001 - any transport failure
            sup.mark_down(self._tick, f"PlaceShard: {exc}")
            self.membership.mark_dead(owner, reason="rpc failed")
            with self._lock:
                self._inline_fallbacks += 1
            _inline_fallbacks_total.inc()
            return None
        with self._lock:
            self._remote_solves += 1
            self._last_remote_tick = self._tick
        _remote_solves_total.inc()
        return placement_from_response(resp, batch.num_shards, snapshot.num_nodes)

    # ---- introspection ----

    def stats(self) -> dict:
        """Deterministic membership facts only (see module docstring)."""
        return {
            "replicas": self.config.replicas,
            "live_final": len(self.membership.live()),
            "rekeys": self.membership.rekey_count,
            "lease_expiries": self.membership.lease_expiries,
            "kills": self.kills,
            "recovery_ticks": self.recovery_ticks,
        }

    def remote_stats(self) -> dict:
        """Volatile transport counters (quality section, not digests)."""
        with self._lock:
            return {
                "remote_solves": self._remote_solves,
                "inline_fallbacks": self._inline_fallbacks,
                "sidecar_restarts": sum(
                    s.restart_count for s in self.supervisors.values()
                ),
            }

    def federated(self) -> dict[str, dict[str, float]]:
        """Latest per-replica sidecar counter snapshot (volatile)."""
        with self._lock:
            return {rid: dict(snap) for rid, snap in self._federated.items()}

    def timeline(self) -> list[dict]:
        """The structured lifecycle timeline: tick-stamped spawn / ready /
        dead / backoff / restart / expire / rekey / kill events."""
        return list(self.events)

    def fleet_section(self) -> dict:
        """The flight record's ``fleet`` section (ISSUE 20): the lifecycle
        timeline plus the last federated counter snapshot — everything a
        post-mortem needs to read a kill/backoff/restart sequence without
        a live process. Volatile; rides the scenario JSON, never the
        determinism digests."""
        return {
            "timeline": self.timeline(),
            "replica_counters": self.federated(),
        }

    def fleetz(self) -> str:
        """Text zpage body for /debug/fleetz."""
        lines = [
            "fleet runtime",
            f"  replicas: {self.config.replicas}  "
            f"live: {len(self.membership.live())}  "
            f"leader: {'yes' if self._is_leader else 'no'}",
            f"  rekeys: {self.membership.rekey_count}  "
            f"lease_expiries: {self.membership.lease_expiries}  "
            f"kills: {self.kills}  recovery_ticks: {self.recovery_ticks}",
        ]
        rs = self.remote_stats()
        lines.append(
            f"  remote_solves: {rs['remote_solves']}  "
            f"inline_fallbacks: {rs['inline_fallbacks']}  "
            f"sidecar_restarts: {rs['sidecar_restarts']}"
        )
        staleness = (
            self._tick - self._last_remote_tick
            if self._last_remote_tick >= 0 else -1
        )
        lines.append(f"  gossip_staleness_ticks: {staleness}")
        lines.append("")
        lines.append("replicas")
        for rid in sorted(self.supervisors):
            sup = self.supervisors[rid]
            rec = self.membership.replicas.get(rid, {})
            state = rec.get("state", "absent")
            lines.append(
                f"  {rid:<12} {state:<5} incarnation={sup.incarnation or '-'} "
                f"restarts={sup.restart_count} "
                f"down_reason={sup.down_reason or '-'}"
            )
        num_shards = getattr(self, "num_shards", 0)
        if num_shards:
            lines.append("")
            lines.append("shard ownership")
            for rid, sids in sorted(self.membership.shard_sets(num_shards).items()):
                lines.append(f"  {rid:<12} shards={list(sids)}")
        federated = self.federated()
        if federated:
            lines.append("")
            lines.append("federated sidecar counters (nonzero)")
            for rid in sorted(federated):
                lines.append(f"  {rid}")
                snap = federated[rid]
                shown = 0
                for cname in sorted(snap):
                    if snap[cname] == 0.0:
                        continue
                    lines.append(f"    {cname:<44} {snap[cname]:g}")
                    shown += 1
                if not shown:
                    lines.append("    (all zero)")
        if self.events:
            lines.append("")
            lines.append("lifecycle timeline (last 12)")
            lines.append(render_timeline(self.events, limit=12))
        return "\n".join(lines) + "\n"
