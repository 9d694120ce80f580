"""Lease-stamped, WAL-persisted replica membership table.

One JSON snapshot (atomic replace, bridge/state.py discipline) holds the
current record per replica; an append-only ``membership.wal`` JSONL logs
the *events* (join / dead / expire / rekey — NOT per-tick renews, which
would dwarf the signal) so a restarted leader can replay how the live set
got here. The live set alone keys shard ownership:

    owner_of(sid) = live[sid % len(live)]     # live = sorted live ids

which is deterministic in the membership (no hashing, no randomness), so
a dead replica's shard-set re-keys to survivors the instant the live set
changes, and the fleet-of-1 twin trivially owns everything.

Time is injected (``clock=``) so the sim drives leases on virtual time.
"""

from __future__ import annotations

import json
import os
import time


class MembershipTable:
    """Replica records + lease bookkeeping + the shard->owner key."""

    def __init__(self, path: str, *, lease_duration: float = 15.0, clock=time.time):
        self.path = path
        self.wal_path = path + ".wal"
        self.lease_duration = float(lease_duration)
        self.clock = clock
        self.replicas: dict[str, dict] = {}
        self.rekey_count = 0
        self.lease_expiries = 0
        self._last_live: tuple[str, ...] = ()
        if os.path.exists(path):
            with open(path, encoding="utf-8") as fh:
                snap = json.load(fh)
            self.replicas = snap.get("replicas", {})
            self.rekey_count = int(snap.get("rekey_count", 0))
            self.lease_expiries = int(snap.get("lease_expiries", 0))
            self._last_live = tuple(self.live())

    # ---- persistence ----

    def _event(self, kind: str, **fields) -> None:
        rec = {"event": kind, "at": self.clock(), **fields}
        with open(self.wal_path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(rec, sort_keys=True) + "\n")

    def _flush(self) -> None:
        tmp = self.path + ".tmp"
        snap = {
            "replicas": self.replicas,
            "rekey_count": self.rekey_count,
            "lease_expiries": self.lease_expiries,
        }
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(snap, fh, sort_keys=True, indent=1)
        os.replace(tmp, self.path)

    # ---- membership ----

    def join(self, replica_id: str, incarnation: str, endpoint: str) -> None:
        now = self.clock()
        self.replicas[replica_id] = {
            "replica_id": replica_id,
            "incarnation": incarnation,
            "endpoint": endpoint,
            "acquired": now,
            "renewed": now,
            "expires": now + self.lease_duration,
            "state": "live",
        }
        self._event("join", replica=replica_id, incarnation=incarnation)
        self._note_live_change()
        self._flush()

    def renew(self, replica_id: str) -> None:
        rec = self.replicas.get(replica_id)
        if rec is None or rec["state"] != "live":
            return
        now = self.clock()
        rec["renewed"] = now
        rec["expires"] = now + self.lease_duration
        # renews are per-tick noise: snapshot only, no WAL event

    def mark_dead(self, replica_id: str, reason: str = "") -> None:
        rec = self.replicas.get(replica_id)
        if rec is None or rec["state"] == "dead":
            return
        rec["state"] = "dead"
        self._event("dead", replica=replica_id, reason=reason)
        self._note_live_change()
        self._flush()

    def expire(self) -> list[str]:
        """Mark replicas whose lease lapsed; returns the newly-dead ids."""
        now = self.clock()
        lapsed = [
            rid
            for rid, rec in self.replicas.items()
            if rec["state"] == "live" and rec["expires"] < now
        ]
        for rid in lapsed:
            self.lease_expiries += 1
            rec = self.replicas[rid]
            rec["state"] = "dead"
            self._event("expire", replica=rid, expired=rec["expires"])
        if lapsed:
            self._note_live_change()
            self._flush()
        return lapsed

    # ---- shard keying ----

    def live(self) -> list[str]:
        return sorted(
            rid for rid, rec in self.replicas.items() if rec["state"] == "live"
        )

    def owner_of(self, sid: int) -> str | None:
        live = self.live()
        if not live:
            return None
        return live[sid % len(live)]

    def shard_sets(self, num_shards: int) -> dict[str, tuple[int, ...]]:
        """Deterministic shard-set per live replica (modulo key)."""
        out: dict[str, list[int]] = {rid: [] for rid in self.live()}
        live = self.live()
        for sid in range(num_shards):
            if live:
                out[live[sid % len(live)]].append(sid)
        return {rid: tuple(sids) for rid, sids in out.items()}

    def _note_live_change(self) -> None:
        live = tuple(self.live())
        if live != self._last_live:
            self.rekey_count += 1
            self._event("rekey", live=list(live), count=self.rekey_count)
            self._last_live = live
