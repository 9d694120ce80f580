"""Agent job-state journal — WAL-backed durability for the login-node daemon.

The agent is the durability weak link when the control plane restarts
around it (JIRIAF's virtual-kubelet HPC integration, PAPERS.md
arxiv 2502.18596): the bridge's snapshot+WAL (PR-7) survives a bridge
crash, but the agent's in-memory submit ledger — the idempotency map
that keeps retried submissions from becoming resubmission storms — died
with the process, and a SIMULTANEOUS bridge+agent crash could double
submit. This module closes that hole with the same CRC-framed
record/replay machinery the bridge WAL uses (``utils/wal.py``):

- **Ledger records** (``{"op":"ledger","sid":...,"id":...}``) — one per
  submit-dedupe entry, appended durably (group-commit: the batched
  submit's thread-pool fan-out shares fsyncs) the moment the entry is
  made, BEFORE the response leaves the process. A crashed agent reloads
  the ledger and a bridge retry of an in-flight submit dedupes exactly
  as if nothing happened.
- **Job records** (``{"op":"job","id":...,"doc":{...}}``) — level-style
  puts of per-job state, later record wins. The real agent journals the
  submit-time document (id, name, partition, submitter — the reverse
  index that hands a restarted daemon its in-flight job set without a
  full queue scan; Slurm itself remains the job-state truth). The
  simulator's fake agent (``sim/agent.py``) journals every lifecycle
  transition — there the journal carries FULL job state, because
  ``SimCluster`` plays both the daemon and Slurm, and the ``agent_crash``
  fault rebuilds the whole cluster-side truth from replay.
- **Snapshot compaction** — past a record budget the caller checkpoints
  the full state (atomic tmp+rename via the same fsync seam) and the WAL
  truncates. Records and snapshots are stamped with a per-instance
  ``incarnation`` id, so a crash between snapshot install and WAL
  truncate can never replay a previous process's tail (identical to
  ``bridge/persist.py``'s contract); a restarted owner checkpoints first
  to rebase.
- **Replay tolerance** — a torn tail or checksum-corrupt record stops
  replay there with a warning; everything before it survives
  (``tests/test_agent_journal.py`` fuzzes exactly the
  ``tests/test_persist.py`` suite's shapes against this file format).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import uuid
from dataclasses import dataclass, field

from slurm_bridge_tpu_torch.utils.wal import WalWriter, pack_record, read_wal

log = logging.getLogger("sbt.agent.journal")


@dataclass
class JournalState:
    """What :meth:`AgentJournal.load` recovered."""

    ledger: dict[str, int] = field(default_factory=dict)
    jobs: dict[int, dict] = field(default_factory=dict)
    #: incremental-sync cursor state (ISSUE 12 satellite d): the
    #: JobsInfo/Nodes signature+version maps the real agent persists so
    #: a restart does NOT force a full re-deliver to every cursor-
    #: holding caller. Shape: ``{"jobs_version": int, "jobs": {jid:
    #: [ver, sig_hash]}, "nodes": {key_hash: [ver, sig_hash]}}``.
    cursors: dict = field(default_factory=dict)
    #: None = clean; "torn" / "corrupt" = replay stopped at a defect
    #: (prior records kept — mirror of ``utils.wal.read_wal``)
    defect: str | None = None
    #: WAL records replayed (after the snapshot)
    replayed: int = 0


class AgentJournal:
    """Snapshot + WAL journal over ``(ledger, jobs)`` agent state.

    The journal does not own the state — callers append records as they
    mutate and hand the full state back for :meth:`checkpoint` when
    :attr:`needs_compaction` (the journal can't rebuild a snapshot from
    a truncated WAL alone). ``fsync=False`` is the simulator's mode
    (within-process durability, deterministic, no device flushes).
    """

    def __init__(
        self,
        path: str,
        *,
        fsync: bool = True,
        fsync_delay_s: float | None = None,
        compact_records: int = 10_000,
        compact_bytes: int = 4 << 20,
    ):
        self.path = path
        self.wal_path = path + ".wal"
        self.fsync = fsync
        self.fsync_delay_s = fsync_delay_s
        self.compact_records = compact_records
        self.compact_bytes = compact_bytes
        #: stamped into every record + snapshot; replay refuses to apply
        #: another incarnation's WAL tail over this one's snapshot
        self.incarnation = uuid.uuid4().hex
        self._wal = WalWriter(
            self.wal_path, fsync=fsync, fsync_delay_s=fsync_delay_s
        )
        # Orders appends against checkpoints: a record appended after a
        # checkpoint captured its state but before the WAL truncate would
        # be destroyed while covered by NOTHING — the exact durability
        # hole the journal exists to close. Appends hold the barrier only
        # around the buffered write (cheap); the fsync stays OUTSIDE it,
        # so group commit across the submit pool is untouched.
        self._barrier = threading.Lock()
        self.records = 0  # since last compaction
        self.records_total = 0
        self.snapshots_written = 0
        #: optional () → cursors dict, installed by the owner (the real
        #: agent's WorkloadServicer) and folded into every checkpoint so
        #: cursor records survive WAL truncation. None keeps the PR-8
        #: snapshot shape exactly (the sim journal never sets it).
        self.cursors_fn = None

    # ---- append paths ----

    def _append_all(self, payloads: list[dict]) -> None:
        with self._barrier:
            for payload in payloads:
                payload["inc"] = self.incarnation
                end = self._wal.append(pack_record(payload))
                self.records += 1
                self.records_total += 1
        # ONE durability barrier for the whole batch, outside the append
        # barrier: a concurrent checkpoint may truncate past ``end``, in
        # which case sync_to returns via the snapshot-covered check —
        # the records' content was captured by that checkpoint (callers
        # update their state maps BEFORE appending, and capture runs
        # under the barrier)
        self._wal.sync_to(end)

    def _append(self, payload: dict) -> None:
        self._append_all([payload])

    def record_ledger(self, submitter_id: str, job_id: int) -> None:
        """Durably note one submit-dedupe entry. Called BEFORE the submit
        response leaves the process — the write barrier that makes the
        ledger crash-consistent (group-commit keeps a batch submit's
        fan-out at ~1 fsync, not 1 per item). Delegates to
        :meth:`record_submit`, the single owner of the record shapes."""
        self.record_submit(submitter_id, job_id)

    def record_job(self, job_id: int, doc: dict) -> None:
        """Level-style put of one job's state; the latest record for an
        id wins on replay."""
        self._append({"op": "job", "id": int(job_id), "doc": doc})

    def record_submit(
        self, submitter_id: str, job_id: int, doc: dict | None = None
    ) -> None:
        """One submit = ledger entry + (optionally) its job doc behind a
        SINGLE durability barrier — a lone submit with nobody to share a
        group commit with would otherwise pay two device flushes."""
        payloads: list[dict] = []
        if submitter_id:
            payloads.append(
                {"op": "ledger", "sid": submitter_id, "id": int(job_id)}
            )
        if doc is not None:
            payloads.append({"op": "job", "id": int(job_id), "doc": doc})
        if payloads:
            self._append_all(payloads)

    def record_job_cursors(self, entries: list, watermark: int) -> None:
        """Durably note JobsInfo cursor movement: ``entries`` is
        ``[(job_id, version, sig_hash), ...]`` for the jobs whose
        mirror-visible signature changed this call, ``watermark`` the
        resulting jobs-state version. One record per call — the batch
        shares one durability barrier like a batched submit."""
        self._append({
            "op": "jcur",
            "v": int(watermark),
            "e": [[int(j), int(v), str(h)] for j, v, h in entries],
        })

    def record_nodes_cursor(
        self, key_hash: str, sig_hash: str, version: int
    ) -> None:
        """Durably note one Nodes cursor slot's movement (keyed by the
        requested-name-set hash — the raw name set would bloat records
        for zero recovery value)."""
        self._append({
            "op": "ncur",
            "k": str(key_hash),
            "h": str(sig_hash),
            "v": int(version),
        })

    @property
    def needs_compaction(self) -> bool:
        return (
            self.records > self.compact_records
            or self._wal.size > self.compact_bytes
        )

    @property
    def fsyncs(self) -> int:
        return self._wal.fsyncs

    # ---- snapshot + recovery ----

    def checkpoint(self, ledger: dict[str, int], jobs: dict[int, dict]) -> None:
        """Fold the full state into a fresh snapshot (atomic tmp+rename)
        and truncate the WAL. Also the rebase step after :meth:`load`: a
        restarted owner checkpoints first so its new-incarnation records
        never mix with the previous process's tail.

        Only safe when no appends can race (single-threaded owners — the
        sim, startup rebase). Concurrent writers use
        :meth:`checkpoint_with`, which captures state UNDER the append
        barrier."""
        self.checkpoint_with(lambda: (ledger, jobs))

    def checkpoint_with(self, state_fn) -> None:
        """Checkpoint with the state captured atomically: ``state_fn()``
        → ``(ledger, jobs)`` runs while the append barrier is held, so
        every record already appended is reflected in the captured state
        (callers update their maps BEFORE appending) and no record can
        land between capture and truncate — nothing is ever destroyed
        uncovered."""
        from slurm_bridge_tpu_torch.utils.files import atomic_write

        with self._barrier:
            ledger, jobs = state_fn()
            payload = {
                "version": 1,
                "incarnation": self.incarnation,
                "ledger": ledger,
                "jobs": {str(k): v for k, v in jobs.items()},
            }
            if self.cursors_fn is not None:
                # the sync cursors ride every checkpoint, so truncating
                # the WAL can never lose them (satellite d)
                payload["cursors"] = self.cursors_fn()
            atomic_write(
                self.path,
                json.dumps(
                    payload,
                    separators=(",", ":"),
                ),
                # honor the journal's flush mode: the simulator's
                # fsync=False journal must stay device-flush-free on
                # checkpoints too (rename atomicity is kept either way)
                fsync=self.fsync,
            )
            self._wal.truncate()
            self.records = 0
            self.snapshots_written += 1
        log.debug(
            "agent journal: checkpointed %d ledger entries / %d jobs into %s",
            len(ledger), len(jobs), self.path,
        )

    def load(self) -> JournalState:
        """Snapshot + ordered WAL replay. Unknown ops are skipped with a
        warning (forward compatibility); a torn/corrupt tail stops replay
        there — state up to the defect survives."""
        state = JournalState()
        snap_inc = None
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    data = json.load(f)
                snap_inc = data.get("incarnation")
                state.ledger = {
                    str(k): int(v) for k, v in data.get("ledger", {}).items()
                }
                state.jobs = {
                    int(k): v for k, v in data.get("jobs", {}).items()
                }
                cur = data.get("cursors")
                if isinstance(cur, dict):
                    state.cursors = cur
            except (OSError, ValueError, TypeError) as exc:
                log.warning(
                    "agent journal snapshot %s unreadable (%s); "
                    "starting from the WAL alone", self.path, exc,
                )
                state.ledger, state.jobs = {}, {}
        records, _, defect = read_wal(self.wal_path)
        state.defect = defect
        if defect is not None:
            log.warning(
                "agent journal %s has a %s tail; replaying the %d clean "
                "records before it", self.wal_path, defect, len(records),
            )
        for rec in records:
            if snap_inc is not None and rec.get("inc") not in (None, snap_inc):
                # another incarnation's leftover tail (crash between
                # snapshot install and WAL truncate): already folded in
                continue
            op = rec.get("op")
            if op == "ledger":
                state.ledger[str(rec.get("sid"))] = int(rec.get("id", 0))
            elif op == "job":
                state.jobs[int(rec.get("id", 0))] = rec.get("doc") or {}
            elif op == "jcur":
                cur = state.cursors
                cur["jobs_version"] = max(
                    int(cur.get("jobs_version") or 0), int(rec.get("v", 0))
                )
                jmap = cur.setdefault("jobs", {})
                for ent in rec.get("e") or []:
                    jmap[str(int(ent[0]))] = [int(ent[1]), str(ent[2])]
            elif op == "ncur":
                nmap = state.cursors.setdefault("nodes", {})
                nmap[str(rec.get("k"))] = [
                    int(rec.get("v", 0)), str(rec.get("h", "")),
                ]
            else:
                log.warning("agent journal record has unknown op %r; skipped", op)
                continue
            state.replayed += 1
        return state

    def close(self) -> None:
        self._wal.close()
