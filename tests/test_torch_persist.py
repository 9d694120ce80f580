"""Persisted state across the two packages.

The bridge store's snapshot and WAL, and the agent journal, are the
system's carried state: what a restarted bridge or agent resumes from.
The on-disk format is one format. Each package writes it from a run of
the simulator (a policy-driven scenario with a bridge crash and an agent
crash, so the files hold every persisted kind and a WAL of batch
envelopes; the journal's records of every op are written directly), and
each package reads
what either wrote: the same objects, resource versions included, and the
same decisions at a torn tail, a corrupt record and a foreign
incarnation's tail. No tolerance.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import types

import pytest

import slurm_bridge_tpu.agent.journal as jax_journal
import slurm_bridge_tpu.bridge.persist as jax_persist
import slurm_bridge_tpu.bridge.store as jax_store
import slurm_bridge_tpu.parallel.colpool as jax_colpool
import slurm_bridge_tpu.sim.faults as jax_faults
import slurm_bridge_tpu.sim.harness as jax_harness
import slurm_bridge_tpu.sim.scenarios as jax_scenarios
import slurm_bridge_tpu.utils.wal as jax_wal
import slurm_bridge_tpu_torch.agent.journal as port_journal
import slurm_bridge_tpu_torch.bridge.persist as port_persist
import slurm_bridge_tpu_torch.bridge.store as port_store
import slurm_bridge_tpu_torch.parallel.colpool as port_colpool
import slurm_bridge_tpu_torch.sim.faults as port_faults
import slurm_bridge_tpu_torch.sim.harness as port_harness
import slurm_bridge_tpu_torch.sim.scenarios as port_scenarios
import slurm_bridge_tpu_torch.utils.wal as port_wal

PKG = {
    "jax": types.SimpleNamespace(
        persist=jax_persist, store=jax_store, journal=jax_journal, wal=jax_wal,
        faults=jax_faults, harness=jax_harness, scenarios=jax_scenarios, kw={},
    ),
    "port": types.SimpleNamespace(
        persist=port_persist, store=port_store, journal=port_journal, wal=port_wal,
        faults=port_faults, harness=port_harness, scenarios=port_scenarios,
        kw={"device": "cpu"},
    ),
}
#: the kinds the run must leave in the snapshot or WAL
KINDS = ("BridgeJob", "Pod", "VirtualNode", "PolicyState")
FOREIGN = "f" * 32
#: the files are taken after this tick's flush: the bridge restarted at
#: tick 4, the agent at tick 6, both snapshots were written since, and
#: both WALs hold the records appended after them
CAPTURE_TICK = 10


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Each package's state directory after :data:`CAPTURE_TICK`: the
    bridge's ``bridge-state.json`` (+ ``.wal``) and ``agent-journal.json``
    (+ ``.wal``)."""
    prior = os.environ.get("SBT_COLPOOL_WORKERS")
    os.environ["SBT_COLPOOL_WORKERS"] = "2"
    out = {}
    try:
        for name, pkg in PKG.items():
            f = pkg.faults
            sc = dataclasses.replace(
                pkg.scenarios.interactive_storm(scale=0.05),
                faults=f.FaultPlan((
                    f.Fault(kind="crash_restart", start_tick=4, end_tick=5),
                    f.Fault(kind="agent_crash", start_tick=6, end_tick=7),
                )),
                persistence=True,
            )
            h = pkg.harness.SimHarness(sc, **pkg.kw)
            dest = tmp_path_factory.mktemp(f"{name}-state")
            run_tick = h.run_tick

            def keep(tick, h=h, dest=dest, run_tick=run_tick, **kw):
                phases = run_tick(tick, **kw)
                if tick == CAPTURE_TICK:
                    shutil.copytree(h._state_dir, dest, dirs_exist_ok=True)
                return phases

            h.run_tick = keep
            result = h.run()
            assert result.determinism["restarts"] == 1
            assert result.determinism["agent_restarts"] == 1
            out[name] = dest
    finally:
        port_colpool.reset()
        jax_colpool.reset()
        if prior is None:
            os.environ.pop("SBT_COLPOOL_WORKERS", None)
        else:
            os.environ["SBT_COLPOOL_WORKERS"] = prior
    return out


def _copy(src_dir, dst_dir, stem):
    for suffix in ("", ".wal"):
        if os.path.exists(os.path.join(src_dir, stem + suffix)):
            shutil.copy(os.path.join(src_dir, stem + suffix), os.path.join(dst_dir, stem + suffix))
    return str(os.path.join(dst_dir, stem))


def _load(pkg, path):
    """(objects restored, every persisted object as its package encodes
    it, in kind and name order)."""
    store = pkg.store.ObjectStore()
    n = pkg.persist.load_into(store, path)
    dump = {
        kind: [pkg.persist._encode(o) for o in sorted(store.list(kind), key=lambda o: o.meta.name)]
        for kind in pkg.persist._kind_registry()
    }
    return n, json.loads(json.dumps(dump, sort_keys=True))


def _append(path, payload):
    with open(path, "ab") as fh:
        fh.write(jax_wal.pack_record(payload))


# ---- the bridge store: snapshot + WAL ------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_state_loads_the_same_into_both_packages(written, writer, tmp_path):
    path = _copy(written[writer], tmp_path, "bridge-state.json")
    records, _, defect = jax_wal.read_wal(path + ".wal")
    assert defect is None and records, "the run left no WAL tail to replay"
    assert any(r.get("op") == "batch" for r in records)
    n_jax, dump_jax = _load(PKG["jax"], path)
    n_port, dump_port = _load(PKG["port"], path)
    assert n_port == n_jax > 0
    assert dump_port == dump_jax
    for kind in KINDS:
        assert dump_jax[kind], f"the run persisted no {kind}"
    # resource versions are part of each object's meta
    assert all("resource_version" in o["meta"] for objs in dump_jax.values() for o in objs)


def test_both_packages_write_the_same_state(written, tmp_path):
    """The two runs' files hold the same objects under the same names."""
    got = {}
    for writer in PKG:
        (tmp_path / writer).mkdir()
        got[writer] = _load(PKG["jax"], _copy(written[writer], tmp_path / writer, "bridge-state.json"))
    names = {w: {k: [o["meta"]["name"] for o in v] for k, v in d.items()} for w, (_, d) in got.items()}
    assert got["port"][0] == got["jax"][0]
    assert names["port"] == names["jax"]


def _snapshot_head(path):
    with open(path) as fh:
        data = json.load(fh)
    return data["incarnation"], int(data["rv"]), data["objects"]


def _extra_pod(objects, name):
    """A put record's object: the snapshot's first pod, renamed."""
    doc = next(d["object"] for d in objects if d["kind"] == "Pod")
    doc = json.loads(json.dumps(doc))
    doc["meta"]["name"] = name
    doc["meta"]["uid"] = name
    return doc


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("defect", ["torn", "corrupt", "foreign", "stale", "clean"])
def test_store_replay_skips_the_same_records(written, writer, defect, tmp_path):
    """A record appended after the run's WAL, then damaged or stamped so
    replay must skip it: a torn tail and a corrupt CRC stop replay there,
    a foreign incarnation's record and one the snapshot already folded in
    are skipped, a clean one of the snapshot's incarnation applies."""
    path = _copy(written[writer], tmp_path, "bridge-state.json")
    inc, snap_rv, objects = _snapshot_head(path)
    rv = snap_rv + 10**6
    stamp = {"foreign": FOREIGN}.get(defect, inc)
    if defect == "stale":
        rv = snap_rv
    _append(path + ".wal", {"op": "put", "kind": "Pod", "rv": rv, "inc": stamp,
                            "object": _extra_pod(objects, "zz-appended")})
    with open(path + ".wal", "r+b") as fh:
        size = fh.seek(0, os.SEEK_END)
        if defect == "torn":
            fh.truncate(size - 5)
        elif defect == "corrupt":
            fh.seek(size - 3)
            byte = fh.read(1)
            fh.seek(size - 3)
            fh.write(bytes([byte[0] ^ 0xFF]))
    want = {"torn": "torn", "corrupt": "corrupt"}.get(defect)
    for pkg in PKG.values():
        assert pkg.wal.read_wal(path + ".wal")[2] == want
    n_jax, dump_jax = _load(PKG["jax"], path)
    n_port, dump_port = _load(PKG["port"], path)
    assert (n_port, dump_port) == (n_jax, dump_jax)
    names = [o["meta"]["name"] for o in dump_jax["Pod"]]
    assert ("zz-appended" in names) == (defect == "clean")


# ---- the agent journal ---------------------------------------------------


def _journal_state(pkg, path):
    st = pkg.journal.AgentJournal(path, fsync=False).load()
    return json.loads(json.dumps(dataclasses.asdict(st), sort_keys=True))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_agent_journal_loads_the_same_into_both_packages(written, writer, tmp_path):
    path = _copy(written[writer], tmp_path, "agent-journal.json")
    a, b = _journal_state(PKG["jax"], path), _journal_state(PKG["port"], path)
    assert a == b
    assert a["jobs"] and a["defect"] is None


def _write_journal(pkg, path):
    """Every record op, across a checkpoint, then a second incarnation's
    records after a restart."""
    j = pkg.journal.AgentJournal(path, fsync=False)
    j.cursors_fn = lambda: {"jobs_version": 3, "jobs": {"1": [3, "s1"]}, "nodes": {}}
    j.record_submit("sub-a", 1, {"state": 1, "name": "a"})
    j.record_job(2, {"state": 2})
    j.checkpoint({"sub-a": 1}, {1: {"state": 1, "name": "a"}, 2: {"state": 2}})
    j.record_ledger("sub-b", 3)
    j.record_job_cursors([(3, 4, "s3")], 4)
    j.record_nodes_cursor("k1", "h1", 7)
    j.record_job(1, {"state": 3, "name": "a"})
    j.close()
    k = pkg.journal.AgentJournal(path, fsync=False)
    st = k.load()
    k.cursors_fn = lambda: st.cursors
    k.checkpoint(st.ledger, st.jobs)  # the restart's rebase
    k.record_submit("sub-c", 4, {"state": 1})
    k.close()
    return k.incarnation


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("defect", ["torn", "corrupt", "foreign", "clean"])
def test_agent_journal_replay_skips_the_same_records(writer, defect, tmp_path):
    path = str(tmp_path / "agent-journal.json")
    inc = _write_journal(PKG[writer], path)
    _append(path + ".wal", {"op": "job", "id": 99, "doc": {"state": 5},
                            "inc": FOREIGN if defect == "foreign" else inc})
    with open(path + ".wal", "r+b") as fh:
        size = fh.seek(0, os.SEEK_END)
        if defect == "torn":
            fh.truncate(size - 4)
        elif defect == "corrupt":
            fh.seek(size - 2)
            byte = fh.read(1)
            fh.seek(size - 2)
            fh.write(bytes([byte[0] ^ 0xFF]))
    a, b = _journal_state(PKG["jax"], path), _journal_state(PKG["port"], path)
    assert a == b
    assert a["defect"] == {"torn": "torn", "corrupt": "corrupt"}.get(defect)
    assert ("99" in a["jobs"]) == (defect == "clean")
    assert a["ledger"] == {"sub-a": 1, "sub-b": 3, "sub-c": 4}
    assert a["cursors"]["nodes"] == {"k1": [7, "h1"]}
