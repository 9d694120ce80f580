"""The port's wire layer against ``workload_pb2``, byte for byte.

The port declares the WorkloadManager and PlacementSolver messages itself
(``wire/messages.py``) and encodes them with a hand-written proto3 codec
(``wire/codec.py``); the simulated agent draws its submits from the wire
content, so any byte of drift would move every digest. Held here against
the JAX package's protobuf-generated module (protobuf is installed on
this host):

- the schema: every message, field number, type and label, every enum
  value and every service method;
- ``SerializeToString`` equal to pb2's over seeded random messages of
  every type (negative ints, empty and non-empty repeated fields,
  unicode strings, ``-0.0`` and NaN doubles, nested messages), and
  ``FromString`` round trips;
- the in-place repeated-field API the simulated agent's caches rely on;
- the hand submit encoders and the column decoders equal across
  packages on the same inputs;
- the bounded retry wrapper, with the port's ``RpcError``.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from slurm_bridge_tpu.wire import workload_pb2 as pb2
from slurm_bridge_tpu_torch.wire import codec
from slurm_bridge_tpu_torch.wire import messages as pm

import slurm_bridge_tpu.core.types as jax_types
import slurm_bridge_tpu.parallel.writeops as jax_writeops
import slurm_bridge_tpu.sim.faults as jax_faults
import slurm_bridge_tpu.wire.coldec as jax_coldec
import slurm_bridge_tpu.wire.convert as jax_convert
import slurm_bridge_tpu.wire.rpc as jax_rpc
import slurm_bridge_tpu_torch.core.types as port_types
import slurm_bridge_tpu_torch.parallel.writeops as port_writeops
import slurm_bridge_tpu_torch.sim.faults as port_faults
import slurm_bridge_tpu_torch.wire.coldec as port_coldec
import slurm_bridge_tpu_torch.wire.convert as port_convert
import slurm_bridge_tpu_torch.wire.rpc as port_rpc
from slurm_bridge_tpu_torch.wire.errors import StatusCode

MESSAGES = sorted(pb2.DESCRIPTOR.message_types_by_name)


# ---- the schema ---------------------------------------------------------


def test_every_message_of_the_proto_is_ported():
    assert sorted(pm.DESCRIPTOR.message_types_by_name) == MESSAGES


@pytest.mark.parametrize("name", MESSAGES)
def test_fields_match_the_proto(name):
    ref = pb2.DESCRIPTOR.message_types_by_name[name]
    port = pm.DESCRIPTOR.message_types_by_name[name]

    def row(f):
        msg = f.message_type.name if f.message_type is not None else ""
        return (f.name, f.number, f.type, f.is_repeated, msg)

    assert [row(f) for f in port.fields] == [row(f) for f in ref.fields]


def test_enums_and_services_match_the_proto():
    for enum in ("JobStatus", "TailAction"):
        for v in pb2.DESCRIPTOR.enum_types_by_name[enum].values:
            assert getattr(pm, v.name) == getattr(pb2, v.name) == v.number
    for svc in ("WorkloadManager", "PlacementSolver"):
        ref = pb2.DESCRIPTOR.services_by_name[svc]
        port = pm.DESCRIPTOR.services_by_name[svc]
        assert port.full_name == ref.full_name
        assert [
            (m.name, m.input_type.name, m.output_type.name,
             m.client_streaming, m.server_streaming)
            for m in port.methods
        ] == [
            (m.name, m.input_type.name, m.output_type.name,
             m.client_streaming, m.server_streaming)
            for m in ref.methods
        ]
    _, jspecs = jax_rpc.service_methods("WorkloadManager")
    _, pspecs = port_rpc.service_methods("WorkloadManager")
    assert [
        (s.name, s.request_streaming, s.response_streaming, s.req_cls.__name__)
        for s in pspecs
    ] == [
        (s.name, s.request_streaming, s.response_streaming, s.req_cls.__name__)
        for s in jspecs
    ]


# ---- random messages, byte for byte --------------------------------------

_INT64 = st.one_of(
    st.integers(-(2**63), 2**63 - 1),
    st.sampled_from([0, 1, -1, 127, 128, -128, 2**31, -(2**31), 2**63 - 1, -(2**63)]),
)
_INT32 = st.integers(-(2**31), 2**31 - 1)
_DOUBLE = st.one_of(
    st.floats(allow_nan=True, allow_infinity=True),
    st.sampled_from([0.0, -0.0, 1.5, float("inf"), float("nan")]),
)


def _scalar(ftype):
    return {
        codec.INT64: _INT64,
        codec.INT32: _INT32,
        codec.ENUM: st.integers(-3, 9),
        codec.BOOL: st.booleans(),
        codec.DOUBLE: _DOUBLE,
        codec.STRING: st.text(max_size=12),
        codec.BYTES: st.binary(max_size=12),
    }[ftype]


def _spec(name: str, depth: int = 0):
    """A dict of field values for message ``name`` (nested messages as
    dicts), every field optional."""
    desc = pm.DESCRIPTOR.message_types_by_name[name]
    parts = {}
    for f in desc.fields:
        if f.type == codec.MESSAGE:
            if depth >= 2:
                continue
            elem = _spec(f.message_type.name, depth + 1)
        else:
            elem = _scalar(f.type)
        parts[f.name] = st.lists(elem, max_size=3) if f.is_repeated else elem
    return st.fixed_dictionaries({}, optional=parts)


def _build(mod, name: str, spec: dict):
    desc = pm.DESCRIPTOR.message_types_by_name[name]
    kw = {}
    for key, value in spec.items():
        f = desc.fields_by_name[key]
        if f.type == codec.MESSAGE:
            sub = f.message_type.name
            value = (
                [_build(mod, sub, v) for v in value] if f.is_repeated
                else _build(mod, sub, value)
            )
        kw[key] = value
    return getattr(mod, name)(**kw)


@pytest.mark.parametrize("name", MESSAGES)
@settings(max_examples=25, derandomize=True, deadline=None)
@given(data=st.data())
def test_serialize_equals_pb2_and_round_trips(name, data):
    spec = data.draw(_spec(name))
    raw = _build(pb2, name, spec).SerializeToString()
    port = _build(pm, name, spec)
    assert port.SerializeToString() == raw
    assert port.SerializeToString(deterministic=True) == raw
    assert getattr(pm, name).FromString(raw).SerializeToString() == raw


def test_explicit_edge_cases_equal_pb2():
    cases = [
        ("JobStepInfo", dict(exit_code=-1, status=5, id="é")),
        ("JobsInfoRequest", dict(job_ids=[1, 2, -1], since_version=7)),
        ("JobsInfoRequest", dict(job_ids=[])),
        ("PlaceJob", dict(id="a", cpus=1.5, mem_mb=-0.0, gpus=-3,
                          req_features=["x", ""], priority=float("nan"),
                          has_priority_override=True)),
        ("PlaceResponse", dict(free_after=[1.0, 0.0, -0.0], placed=3)),
        ("HealthzResponse", dict(shard_set=[1, -2, 300], metric_total=[0.5])),
        ("SubmitJobRequest", dict(priority=-2, nodelist=["", "n0", "ノード"])),
        ("NodesResponse", dict(nodes=[{}, {"features": ["", "ib"]}], unchanged=True)),
        ("SubmitJobContainerRequest", dict(job={})),
        ("PlaceRequest", dict(config={"gang_first": True})),
    ]
    for name, spec in cases:
        assert _build(pm, name, spec).SerializeToString() == (
            _build(pb2, name, spec).SerializeToString()
        ), name


def test_decode_skips_unknown_fields_and_groups_like_pb2():
    msg = pb2.JobInfo(id=7, name="n", run_time_s=-3, reason="r")
    unknown = (
        codec._varint(300 << 3 | 0) + codec._varint(5)
        + codec._varint(301 << 3 | 2) + b"\x02ab"
        + codec._varint(302 << 3 | 5) + b"\x00\x01\x02\x03"
        + codec._varint(303 << 3 | 1) + bytes(8)
        + codec._varint(304 << 3 | 3) + codec._varint(1 << 3) + b"\x01"
        + codec._varint(304 << 3 | 4)
    )
    raw = unknown + msg.SerializeToString() + unknown
    assert pm.JobInfo.FromString(raw).SerializeToString() == msg.SerializeToString()
    # a repeated scalar's last occurrence wins, as pb2's does
    dup = msg.SerializeToString() + bytes([5 << 3]) + b"\x02"
    assert pm.JobInfo.FromString(dup).status == pb2.JobInfo.FromString(dup).status == 2


@pytest.mark.parametrize("raw", [
    b"\x0a\x05abc",  # length past the end
    b"\x08",  # truncated varint
    b"\x08" + b"\xff" * 10 + b"\x01",  # varint over 10 bytes
    b"\x00\x01",  # field number 0
    b"\x1a\x02\xff\xfe",  # invalid UTF-8 in a string
])
def test_malformed_bytes_raise_like_pb2(raw):
    from google.protobuf.message import DecodeError as PbDecodeError

    with pytest.raises(PbDecodeError):
        pb2.JobInfo.FromString(raw)
    with pytest.raises(codec.DecodeError):
        pm.JobInfo.FromString(raw)


def test_packed_and_unpacked_repeated_numbers_decode_alike():
    packed = pb2.JobsInfoRequest(job_ids=[3, -4, 5]).SerializeToString()
    unpacked = b"".join(b"\x08" + codec._varint(v) for v in (3, -4, 5))
    for raw in (packed, unpacked):
        assert list(pm.JobsInfoRequest.FromString(raw).job_ids) == [3, -4, 5]
        assert list(pb2.JobsInfoRequest.FromString(raw).job_ids) == [3, -4, 5]


# ---- the in-place API ---------------------------------------------------


@pytest.mark.parametrize("mod", [pb2, pm], ids=["pb2", "port"])
def test_repeated_add_holds_and_append_copies(mod):
    r = mod.JobsInfoResponse()
    held = r.jobs.add(job_id=1)
    held.job_id = 2  # a write to the element the list holds
    e = mod.JobsInfoEntry(job_id=3, found=True)
    r.jobs.append(e)
    e.job_id = 4  # the list holds a copy
    r.jobs.extend([e])
    e.job_id = 5
    assert [j.job_id for j in r.jobs] == [2, 3, 4]
    c = mod.JobsInfoResponse(jobs=[e])
    assert c.jobs[0] is not e and c.jobs[0].job_id == 5
    with pytest.raises(AttributeError):
        r.jobs = []


def test_the_agents_entry_cache_serializes_as_pb2s():
    """The simulated agent keeps one entry per job, fills the info held by
    ``e.info.add()`` and later patches ``run_time_s`` in place before each
    ``append``: every response keeps the snapshot it was given."""
    out = {}
    for mod in (pb2, pm):
        e = mod.JobsInfoEntry(job_id=7, found=True)
        m = e.info.add()
        m.id, m.name, m.status, m.run_time_s = 7, "job-ü", 5, 1
        first = mod.JobsInfoResponse(version=3)
        first.jobs.append(e)
        m.run_time_s = 9
        second = mod.JobsInfoResponse(version=4)
        second.jobs.append(e)
        assert first.jobs[0].info[0].run_time_s == 1
        assert second.jobs[0].info[0].run_time_s == 9
        out[mod] = (first.SerializeToString(), second.SerializeToString())
    assert out[pm] == out[pb2]


def test_nested_message_presence_like_pb2():
    """Reading an unset nested message does not make it present; setting
    one of its fields, or passing it to the constructor, does."""
    for mod in (pb2, pm):
        m = mod.SubmitJobContainerRequest()
        assert m.job.script == ""
        assert m.SerializeToString() == b""
        m.job.script = "x"
        assert m.SerializeToString() == b"\n\x03\n\x01x"
    assert (
        pm.SubmitJobContainerRequest(job=pm.SubmitJobRequest()).SerializeToString()
        == pb2.SubmitJobContainerRequest(job=pb2.SubmitJobRequest()).SerializeToString()
        == b"\n\x00"
    )


# ---- the hand encoders and the column decoders, across packages ----------


def _demand_rows(seed: int, n: int):
    """(JAX rows, port rows) of the same random submit demands."""
    from tests.test_colpool_write import _random_demands

    jrows = _random_demands(seed, n)
    prows = [
        (port_types.JobDemand(**dataclasses.asdict(d)), sub) for d, sub in jrows
    ]
    return jrows, prows


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_submit_encoders_equal_across_packages(seed):
    jrows, prows = _demand_rows(seed, 60)
    for (jd, sub), (pd, _) in zip(jrows, prows):
        assert port_convert.encode_submit_request(pd, sub) == (
            jax_convert.encode_submit_request(jd, sub)
        )
    jframe = jax_writeops.pack_submit_frame(jrows)
    pframe = port_writeops.pack_submit_frame(prows)
    assert pframe == jframe
    got = port_writeops.encode_submit_frame(memoryview(pframe))
    assert got == jax_writeops.encode_submit_frame(memoryview(jframe))
    # … and the port's messages, filled as the provider fills them
    breq = pm.SubmitJobsRequest()
    for pd, sub in prows:
        port_convert.fill_submit_request(breq.requests.add(), pd, sub)
    assert breq.SerializeToString() == got


@pytest.mark.parametrize("seed", [4, 5])
def test_jobs_info_columns_equal_across_packages(seed):
    from tests.test_colpool import _assert_chunk_equal
    from tests.test_coldec import _random_response

    rng = np.random.default_rng(seed)
    for _ in range(40):
        raw = _random_response(rng).SerializeToString()
        _assert_chunk_equal(
            port_coldec.decode_jobs_info(raw), jax_coldec.decode_jobs_info(raw)
        )


def test_nodes_and_submit_columns_equal_across_packages():
    rng = np.random.default_rng(6)
    resp = pb2.NodesResponse(version=11)
    for i in range(40):
        resp.nodes.add(
            name=f"n{i}", cpus=int(rng.integers(0, 256)),
            alloc_cpus=int(rng.integers(0, 256)),
            memory_mb=int(rng.integers(0, 1 << 20)),
            gpus=int(rng.integers(0, 8)),
            gpu_type="h100" if rng.random() < 0.3 else "",
            features=["ib", "nvme"][: int(rng.integers(0, 3))],
            state=["", "IDLE", "MIXED", "DRAINED"][int(rng.integers(0, 4))],
        )
    raw = resp.SerializeToString()
    j, p = jax_coldec.decode_nodes(raw), port_coldec.decode_nodes(raw)
    assert (p.version, p.unchanged) == (j.version, j.unchanged)
    assert [dataclasses.astuple(n) for n in p.nodes] == [
        dataclasses.astuple(n) for n in j.nodes
    ]
    sub = pb2.SubmitJobsResponse()
    sub.results.add(job_id=1001, ok=True)
    sub.results.add(ok=False, error_code="UNAVAILABLE", error="flap ✗")
    raw = sub.SerializeToString()
    j, p = jax_coldec.decode_submit_jobs(raw), port_coldec.decode_submit_jobs(raw)
    for col in ("job_id", "ok", "error_code", "error"):
        assert getattr(p, col).tolist() == getattr(j, col).tolist(), col


def test_coldec_is_available_in_the_port():
    """The mirror's bytes path needs the decoder's tables to match the
    port's schema; otherwise the provider would quietly take the object
    path."""
    assert port_coldec.verify_tables() == []
    assert port_coldec.available()


def test_job_info_converters_equal_across_packages():
    import datetime

    kw = dict(
        id=12, user_id="u", name="job", exit_code="0:0",
        state=port_types.JobStatus.RUNNING,
        submit_time=datetime.datetime(2026, 1, 2, 3, 4, 5),
        start_time=None, run_time_s=-1, time_limit_s=-1, working_dir="/w",
        std_out="/o", std_err="/e", partition="p", node_list="n[1-2]",
        batch_host="n1", num_nodes=2, array_id="", reason="",
    )
    pj = port_types.JobInfo(**kw)
    jj = jax_types.JobInfo(**{**kw, "state": jax_types.JobStatus.RUNNING})
    raw = port_convert.job_info_to_proto(pj).SerializeToString()
    assert raw == jax_convert.job_info_to_proto(jj).SerializeToString()
    back = port_convert.job_info_from_proto(pm.JobInfo.FromString(raw))
    assert dataclasses.astuple(back) == dataclasses.astuple(
        jax_convert.job_info_from_proto(pb2.JobInfo.FromString(raw))
    )


# ---- bounded retries ---------------------------------------------------


def _flaky(errors, code_of, fails: int):
    calls = []

    def fn(request, timeout=None):
        calls.append(timeout)
        if len(calls) <= fails:
            raise errors(code_of("UNAVAILABLE"), "flap")
        return "ok"

    return fn, calls


@pytest.mark.parametrize("fails", [0, 2, 10])
def test_retrying_client_equals_the_jax_package(fails):
    import grpc

    results = []
    for rpc, faults, code_of in (
        (jax_rpc, jax_faults, lambda c: getattr(grpc.StatusCode, c)),
        (port_rpc, port_faults, lambda c: getattr(StatusCode, c)),
    ):
        fn, calls = _flaky(faults.SimRpcError, code_of, fails)

        class Inner:
            def close(self):
                pass

        inner = Inner()
        inner.SubmitJobs = fn
        sleeps = []
        client = rpc.RetryingClient(
            inner, policy=rpc.RetryPolicy(max_attempts=5), sleep=sleeps.append,
            seed=3,
        )
        try:
            out = client.SubmitJobs(object())
        except faults.SimRpcError as e:
            out = e.code().name
        results.append((out, len(calls), sleeps, dict(client.retries)))
    assert results[0] == results[1]


def test_retry_budgets_equal_the_jax_package():
    jp, pp = jax_rpc.DEFAULT_RETRY, port_rpc.DEFAULT_RETRY
    for method in ("SubmitJobs", "JobsInfo", "Nodes", "Healthz"):
        assert pp.deadline_for(method) == jp.deadline_for(method)
        for codes in (("UNAVAILABLE",), jax_rpc.TRANSIENT_CODES):
            a = dataclasses.replace(jp, codes=codes)
            b = dataclasses.replace(pp, codes=codes)
            assert b.attempt_timeout_for(method, None) == a.attempt_timeout_for(method, None)
    assert port_rpc.TRANSIENT_CODES == jax_rpc.TRANSIENT_CODES


def test_double_encoding_is_ieee_little_endian():
    for v in (0.1, -2.5, 1e300):
        raw = pm.PlaceJob(cpus=v).SerializeToString()
        assert raw == b"\x51" + struct.pack("<d", v)
