"""Descriptor-driven RPC wiring: the method table, bounded retries and the
gRPC transport.

The JAX package derives gRPC stubs and servicers from the protobuf
descriptor at runtime. The port does the same from its own schema
(:mod:`~slurm_bridge_tpu_torch.wire.messages`), whose message classes
serve as grpc's serializers (``SerializeToString`` / ``FromString``, byte
for byte what ``workload_pb2`` writes), so no protobuf is needed:

- the per-service method table (:func:`service_methods`) and the bounded
  retry wrapper (:class:`RetryPolicy`, :func:`call_with_retries`,
  :class:`RetryingClient`), which need no transport and run on the card's
  machine (the simulator's agent is an object in the same process);
- the transport (:func:`dial`, the channel-backed :class:`ServiceClient`
  with its raw-bytes twins, :func:`generic_handler`, :func:`serve`), which
  imports ``grpc`` only when called.

Errors cross the transport in the port's own terms: a ``grpc.RpcError``
that reaches a :class:`ServiceClient` call is raised as the port's
:class:`~slurm_bridge_tpu_torch.wire.errors.RpcError` with the same status
code (so :func:`call_with_retries` retries it), and a servicer served by
:func:`serve` aborts with the port's
:class:`~slurm_bridge_tpu_torch.wire.errors.StatusCode`, which reaches the
peer as grpc's code of the same name. :class:`LocalContext` is the context
of a servicer called in process, with no transport at all.

Endpoint grammar mirrors the reference's dial sites: an endpoint ending in
``.sock`` dials/binds a unix-domain socket, anything else TCP.
"""

from __future__ import annotations

import logging
import random
import time
from dataclasses import dataclass

from slurm_bridge_tpu_torch.wire import messages as pb
from slurm_bridge_tpu_torch.wire.errors import RpcError, StatusCode


@dataclass(frozen=True)
class MethodSpec:
    name: str
    request_streaming: bool
    response_streaming: bool
    req_cls: type
    resp_cls: type

    @property
    def kind(self) -> str:
        return {
            (False, False): "unary_unary",
            (False, True): "unary_stream",
            (True, False): "stream_unary",
            (True, True): "stream_stream",
        }[(self.request_streaming, self.response_streaming)]


def service_methods(service_name: str) -> tuple[str, list[MethodSpec]]:
    """(full service name, method specs) for a service in workload.proto."""
    svc = pb.DESCRIPTOR.services_by_name[service_name]
    specs = [
        MethodSpec(
            name=m.name,
            request_streaming=m.client_streaming,
            response_streaming=m.server_streaming,
            req_cls=m.input_type._concrete_class,
            resp_cls=m.output_type._concrete_class,
        )
        for m in svc.methods
    ]
    return svc.full_name, specs


def normalize_endpoint(endpoint: str) -> str:
    """Reference semantics: *.sock → unix-domain socket target."""
    if endpoint.startswith(("unix:", "dns:", "ipv4:", "ipv6:")):
        return endpoint
    if endpoint.endswith(".sock"):
        return f"unix://{endpoint}" if endpoint.startswith("/") else f"unix:{endpoint}"
    return endpoint


def dial(endpoint: str):
    """Open an insecure ``grpc.Channel`` (the reference dials insecure
    everywhere)."""
    import grpc

    return grpc.insecure_channel(normalize_endpoint(endpoint))


# --------------------------------------------------------------- retries

@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry for transient unary-call failures.

    Exponential backoff with equal jitter, capped per-attempt delay, an
    overall deadline, and a closed set of retryable codes. The DEFAULT
    retries only UNAVAILABLE — the transport-flap shape (agent restart,
    wire blip) where the request almost certainly never reached the
    server. DEADLINE_EXCEEDED is transient too but NOT default-safe: the
    deadline can expire AFTER the server processed the call, so retrying
    a ledger-less SubmitJob would duplicate the Slurm job. Callers whose
    writes are idempotent — the bridge, whose every submit carries a
    ``submitter_id`` the agent's journal-backed ledger dedupes
    (``agent/server.py`` + ``agent/journal.py``) — opt in via
    ``RetryPolicy(codes=TRANSIENT_CODES)``. Everything else (NOT_FOUND,
    INVALID_ARGUMENT, INTERNAL…) is the server answering and surfaces
    immediately.
    """

    max_attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 1.0
    multiplier: float = 2.0
    #: give up once the NEXT sleep would cross this much elapsed time —
    #: the FALLBACK for methods without a ``method_budgets`` entry
    deadline_s: float = 8.0
    codes: tuple[str, ...] = ("UNAVAILABLE",)
    #: per-RPC budgets: method → (retry deadline s, per-attempt timeout
    #: s). One global deadline treats a 2 k-request SubmitJobs batch and
    #: a Partitions ping identically — and worse, an attempt with no RPC
    #: timeout can hang until the transport gives up, eating the WHOLE
    #: retry budget in one try (the ROADMAP durability leftover). The
    #: table sizes the deadline to the method's real cost and bounds
    #: each attempt so a slow attempt leaves room to retry; a caller's
    #: explicit ``timeout=`` always wins over the table's.
    method_budgets: tuple[tuple[str, float, float], ...] = ()

    def backoff_s(self, attempt: int, rng) -> float:
        """Delay before retry ``attempt`` (1-based): exponential, capped,
        equal-jitter (half fixed + half uniform — never collapses to 0,
        never synchronizes a thundering herd)."""
        raw = min(
            self.max_delay_s, self.base_delay_s * self.multiplier ** (attempt - 1)
        )
        return raw / 2.0 + rng.random() * raw / 2.0

    def _budget(self, method: str) -> tuple[float, float] | None:
        # memoized dict over the tuple: call_with_retries consults the
        # budget on EVERY unary RPC (tens of thousands per sim run) —
        # lazily built because the dataclass is frozen
        table = self.__dict__.get("_budget_map")
        if table is None:
            table = {name: (d, t) for name, d, t in self.method_budgets}
            object.__setattr__(self, "_budget_map", table)
        return table.get(method)

    def deadline_for(self, method: str) -> float:
        """The retry deadline this method's budget allows."""
        b = self._budget(method)
        return b[0] if b is not None else self.deadline_s

    def attempt_timeout_for(self, method: str, timeout):
        """The per-attempt RPC timeout: the caller's explicit value
        wins; otherwise the method's budgeted attempt timeout — but
        ONLY when this policy retries DEADLINE_EXCEEDED. Injecting a
        timeout under a policy that treats the resulting
        DEADLINE_EXCEEDED as fatal would convert a slow-but-healthy
        call that used to succeed into a zero-retry failure; callers on
        the default UNAVAILABLE-only policy keep unbounded attempts
        (None when the table has no entry either)."""
        if timeout is not None:
            return timeout
        if "DEADLINE_EXCEEDED" not in self.codes:
            return None
        b = self._budget(method)
        return b[1] if b is not None else None


#: both transient shapes — for callers whose writes are ledger-deduped
TRANSIENT_CODES = ("UNAVAILABLE", "DEADLINE_EXCEEDED")

#: the WorkloadManager surface's default budgets: heavyweight batched
#: RPCs (a 512-chunk SubmitJobs fans out across the agent's submit pool;
#: JobsInfo answers 45 k rows at the headline shape) get deadlines sized
#: to their cost, cheap inventory/control pings get tight ones — and
#: every entry bounds the per-attempt RPC so one hung call cannot eat
#: the whole retry budget (the attempt bound engages only for callers
#: that retry DEADLINE_EXCEEDED, i.e. ledger-deduped writers like the
#: bridge — see ``attempt_timeout_for``). Values are deliberately
#: generous (≥10× the measured sim-shape costs); the point is
#: proportionality, not tuning.
DEFAULT_METHOD_BUDGETS: tuple[tuple[str, float, float], ...] = (
    # (method, retry deadline s, per-attempt timeout s)
    ("SubmitJobs", 60.0, 30.0),
    ("JobsInfo", 45.0, 20.0),
    ("SubmitJob", 20.0, 10.0),
    ("Nodes", 20.0, 10.0),
    ("Partitions", 8.0, 5.0),
    ("Partition", 8.0, 5.0),
    ("JobInfo", 8.0, 5.0),
    ("JobState", 8.0, 5.0),
    ("CancelJob", 8.0, 5.0),
)

#: the default policy for every unary RPC of the WorkloadManager surface
DEFAULT_RETRY = RetryPolicy(method_budgets=DEFAULT_METHOD_BUDGETS)


def _retries_counter():
    # lazy: wire must stay importable without dragging obs in at module
    # import
    global _RETRIES_TOTAL
    if _RETRIES_TOTAL is None:
        from slurm_bridge_tpu_torch.obs.metrics import REGISTRY

        _RETRIES_TOTAL = REGISTRY.counter(
            "sbt_rpc_retries_total",
            "unary RPC attempts retried after a transient status code",
        )
    return _RETRIES_TOTAL


_RETRIES_TOTAL = None


def _code_name(err: RpcError) -> str:
    code = getattr(err, "code", None)
    if not callable(code):
        return ""
    try:
        c = code()
    except Exception:
        return ""
    return getattr(c, "name", "")


def call_with_retries(
    fn,
    request,
    *,
    method: str,
    policy: RetryPolicy,
    timeout=None,
    sleep=time.sleep,
    clock=time.monotonic,
    rng=None,
    on_retry=None,
):
    """Run one unary call under the retry policy.

    ``sleep``/``clock``/``rng`` are injectable so the simulator retries
    on virtual time (no wall-clock sleeps) and tests are deterministic.
    ``on_retry(method, attempt, code)`` fires before each retry (the
    metric hook; RetryingClient also counts through it).
    """
    rng = rng if rng is not None else random
    start = clock()
    deadline_s = policy.deadline_for(method)
    timeout = policy.attempt_timeout_for(method, timeout)
    attempt = 1
    while True:
        try:
            return fn(request, timeout=timeout)
        except RpcError as err:
            code = _code_name(err)
            if code not in policy.codes or attempt >= policy.max_attempts:
                raise
            delay = policy.backoff_s(attempt, rng)
            if clock() - start + delay > deadline_s:
                raise
            _retries_counter().inc(method=method)
            if on_retry is not None:
                on_retry(method, attempt, code)
            sleep(delay)
            attempt += 1


class RetryingClient:
    """Bounded-retry wrapper over any WorkloadManager-shaped client —
    the duck-typed form the simulator stacks over its :class:`FaultyClient`.
    Only callable attributes are wrapped; ``close()`` passes through.
    """

    def __init__(
        self,
        inner,
        *,
        policy: RetryPolicy = DEFAULT_RETRY,
        sleep=time.sleep,
        clock=time.monotonic,
        seed: int | None = None,
    ):
        self._inner = inner
        self._policy = policy
        self._sleep = sleep
        self._clock = clock
        self._rng = random.Random(seed) if seed is not None else random
        #: retries performed, by method — the sim's determinism section
        #: reads this (the metric is process-global, runs would bleed)
        self.retries: dict[str, int] = {}

    def close(self) -> None:
        self._inner.close()

    def _count(self, method: str, attempt: int, code: str) -> None:
        self.retries[method] = self.retries.get(method, 0) + 1

    def __getattr__(self, name: str):
        inner_fn = getattr(self._inner, name)
        if not callable(inner_fn) or name.startswith("_"):
            return inner_fn

        def call(request, timeout=None):
            return call_with_retries(
                inner_fn,
                request,
                method=name,
                policy=self._policy,
                timeout=timeout,
                sleep=self._sleep,
                clock=self._clock,
                rng=self._rng,
                on_retry=self._count,
            )

        # memoize: __getattr__ only fires on cache misses afterwards —
        # the sim routes tens of thousands of calls per run through here
        setattr(self, name, call)
        return call


# --------------------------------------------------------------- transport

#: method name → ``fn(client_span, response)``, invoked while the
#: ``rpc.client.<Method>`` span is still OPEN (trace stitching): the fleet
#: runtime registers a PlaceShard hook that turns the response's
#: worker-side timing summary into synthetic child spans, so the flight
#: recorder's child-sum bookkeeping attributes the round-trip. Hook
#: failures are swallowed — stitching must never break an RPC.
_CLIENT_SPAN_HOOKS: dict = {}


def set_client_span_hook(method_name: str, hook) -> None:
    """Register (or, with ``hook=None``, clear) a per-method client-span
    response hook. Process-wide, last writer wins."""
    if hook is None:
        _CLIENT_SPAN_HOOKS.pop(method_name, None)
    else:
        _CLIENT_SPAN_HOOKS[method_name] = hook


def _port_error(err) -> RpcError:
    """A ``grpc.RpcError`` as the port's :class:`RpcError`, status code
    unchanged (an error without a code is UNKNOWN)."""
    name = _code_name(err)
    code = StatusCode[name] if name in StatusCode.__members__ else StatusCode.UNKNOWN
    details = getattr(err, "details", None)
    try:
        text = details() if callable(details) else ""
    except Exception:
        text = ""
    return RpcError(code, text or "")


class _PortErrorStream:
    """A response stream whose transport errors surface as the port's
    :class:`RpcError`; every other attribute (``cancel``, ``code``…) is
    the underlying call's."""

    def __init__(self, stream, grpc_error):
        self._stream = stream
        self._grpc_error = grpc_error

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._stream)
        except self._grpc_error as err:
            raise _port_error(err) from err

    def __getattr__(self, name):
        return getattr(self._stream, name)


def _port_errors(multicallable, response_streaming: bool):
    """Wrap a grpc multicallable so its failures raise the port's
    :class:`RpcError` — what :func:`call_with_retries` and every caller of
    the port catch. Where grpc is not installed the channel is not grpc's
    (an in-process one, whose calls raise the port's error themselves), and
    its multicallable is returned as it is."""
    try:
        import grpc
    except ImportError:
        return multicallable

    def call(request, timeout=None, metadata=None):
        try:
            out = multicallable(request, timeout=timeout, metadata=metadata)
        except grpc.RpcError as err:
            raise _port_error(err) from err
        return _PortErrorStream(out, grpc.RpcError) if response_streaming else out

    return call


def _traced_call(method_name: str, multicallable, unary: bool):
    """Wrap a multicallable with trace propagation: when the caller is
    inside an active span, a ``traceparent`` metadata entry rides the RPC
    (so the server-side interceptor parents its span into the caller's
    trace) and — for unary RPCs — a client-side ``rpc.client.<Method>``
    span records the round-trip. Outside a trace the wrapper is a
    pass-through: no metadata, no span, one attribute read of overhead."""
    from slurm_bridge_tpu_torch.obs.tracing import TRACER, format_traceparent

    def call(request, timeout=None, metadata=None):
        parent = TRACER.current()
        if parent is None or not parent.sampled:
            # outside a trace — or inside one the sampler discarded (the
            # whole trace exports or none of it): true pass-through
            return multicallable(request, timeout=timeout, metadata=metadata)
        if not unary:
            # streams outlive the call frame: propagate context only
            md = tuple(metadata or ()) + (
                ("traceparent", format_traceparent(parent)),
            )
            return multicallable(request, timeout=timeout, metadata=md)
        with TRACER.span(f"rpc.client.{method_name}") as span:
            # the server parents under the CLIENT span, not the tick span
            md = tuple(metadata or ()) + (
                ("traceparent", format_traceparent(span)),
            )
            response = multicallable(request, timeout=timeout, metadata=md)
            hook = _CLIENT_SPAN_HOOKS.get(method_name)
            if hook is not None:
                try:
                    hook(span, response)
                except Exception:
                    logging.getLogger("sbt.rpc").exception(
                        "client span hook for %s failed", method_name
                    )
            return response

    return call


def _retrying_call(method_name: str, traced, policy: RetryPolicy):
    """Retry wrapper OUTSIDE the traced call, so every attempt gets its
    own ``rpc.client.<Method>`` span inside an active trace."""

    def call(request, timeout=None, metadata=None):
        return call_with_retries(
            lambda req, timeout=None: traced(req, timeout=timeout, metadata=metadata),
            request,
            method=method_name,
            policy=policy,
            timeout=timeout,
        )

    return call


#: bulk RPCs with a raw-bytes client twin (``<Method>Bytes``): identity
#: response-deserializer, so the caller hands the buffer to
#: :mod:`~slurm_bridge_tpu_torch.wire.coldec` and decodes straight into
#: columns — no response message is ever built. Same wire method, same
#: retry budget, same ``rpc.client.<Method>`` span name.
BYTES_METHODS = ("JobsInfo", "Nodes", "SubmitJobs")


def _identity_bytes(raw: bytes) -> bytes:
    return raw


class ServiceClient:
    """Dynamic client stub over a ``grpc.Channel``: one callable attribute
    per RPC.

    Unary calls carry bounded retries for transient codes (see
    :class:`RetryPolicy`); pass ``retry=None`` to fail fast instead.
    Streams are never retried (they outlive the call frame; the caller
    owns resumption). Every failure raises the port's :class:`RpcError`.

    The bulk methods additionally expose raw-bytes twins
    (:data:`BYTES_METHODS`, e.g. ``client.JobsInfoBytes``) for the
    zero-object wire→column decode; ``coldec=False`` suppresses them.

    >>> client = ServiceClient(dial("localhost:9999"), "WorkloadManager")
    >>> client.SubmitJob(pb.SubmitJobRequest(script="...", partition="debug"))
    """

    def __init__(
        self,
        channel,
        service_name: str,
        *,
        retry: RetryPolicy | None = DEFAULT_RETRY,
        coldec: bool = True,
    ):
        self._channel = channel
        full_name, specs = service_methods(service_name)
        for spec in specs:
            factory = getattr(channel, spec.kind)
            multicallable = _port_errors(
                factory(
                    f"/{full_name}/{spec.name}",
                    request_serializer=spec.req_cls.SerializeToString,
                    response_deserializer=spec.resp_cls.FromString,
                ),
                spec.response_streaming,
            )
            unary = spec.kind == "unary_unary"
            call = _traced_call(spec.name, multicallable, unary=unary)
            if unary and retry is not None:
                call = _retrying_call(spec.name, call, retry)
            setattr(self, spec.name, call)
            if coldec and unary and spec.name in BYTES_METHODS:
                # the request side is a passthrough too: a caller may
                # hand the twin pre-encoded request bytes; a message
                # still serializes exactly as before
                raw_mc = _port_errors(
                    factory(
                        f"/{full_name}/{spec.name}",
                        request_serializer=_bytes_passthrough(
                            spec.req_cls.SerializeToString
                        ),
                        response_deserializer=_identity_bytes,
                    ),
                    False,
                )
                raw_call = _traced_call(spec.name, raw_mc, unary=True)
                if retry is not None:
                    raw_call = _retrying_call(spec.name, raw_call, retry)
                setattr(self, spec.name + "Bytes", raw_call)

    def close(self) -> None:
        self._channel.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LocalContext:
    """The servicer context of an in-process call: ``abort`` raises the
    port's :class:`RpcError` at once, as grpc's context raises to end the
    RPC."""

    def abort(self, code: StatusCode, details: str = ""):
        raise RpcError(code, details)


class _GrpcContext:
    """A grpc servicer context whose ``abort`` takes the port's
    :class:`StatusCode` (grpc's own codes pass unchanged)."""

    def __init__(self, context):
        self._context = context

    def abort(self, code, details: str = ""):
        import grpc

        if isinstance(code, StatusCode):
            code = grpc.StatusCode[code.name]
        self._context.abort(code, details)

    def __getattr__(self, name):
        return getattr(self._context, name)


def _port_servicer_call(fn, response_streaming: bool):
    """A servicer method as grpc calls it: its context speaks the port's
    status codes, and a port :class:`RpcError` it raises ends the RPC with
    that code and details."""

    if response_streaming:
        def handler(request, context):
            ctx = _GrpcContext(context)
            try:
                yield from fn(request, ctx)
            except RpcError as err:
                ctx.abort(err.code(), err.details())
    else:
        def handler(request, context):
            ctx = _GrpcContext(context)
            try:
                return fn(request, ctx)
            except RpcError as err:
                ctx.abort(err.code(), err.details())

    return handler


def generic_handler(servicer, service_name: str):
    """Build the server-side ``grpc.GenericRpcHandler`` table from a
    servicer object.

    The servicer implements methods named after the RPCs (missing ones
    return UNIMPLEMENTED — an absent method degrades to a clean status).
    """
    import grpc

    full_name, specs = service_methods(service_name)
    handlers = {}
    for spec in specs:
        fn = getattr(servicer, spec.name, None)
        if fn is None:
            continue
        maker = getattr(grpc, f"{spec.kind}_rpc_method_handler")
        handlers[spec.name] = maker(
            _port_servicer_call(fn, spec.response_streaming),
            request_deserializer=spec.req_cls.FromString,
            response_serializer=_bytes_passthrough(
                spec.resp_cls.SerializeToString
            ),
        )
    return grpc.method_handlers_generic_handler(full_name, handlers)


def _bytes_passthrough(serialize):
    """Serializer accepting EITHER a message or pre-serialized wire
    bytes. Used on both halves of the bytes fast path: a servicer may
    hand back an already-assembled response buffer, and a Bytes-twin
    caller may hand in a pre-encoded request — the wire is identical
    either way."""

    def ser(resp):
        return resp if isinstance(resp, bytes) else serialize(resp)

    return ser


def serve(
    servicers: dict[str, object],
    endpoint: str,
    *,
    max_workers: int = 16,
    interceptors: tuple = (),
):
    """Start a ``grpc.Server`` hosting {service_name: servicer} at
    endpoint.

    Returns the started server; caller owns shutdown. Binding ``host:0``
    rewrites the port into the returned server's ``bound_port`` attribute.
    """
    from concurrent import futures

    import grpc

    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        interceptors=interceptors,
    )
    for name, servicer in servicers.items():
        server.add_generic_rpc_handlers((generic_handler(servicer, name),))
    target = normalize_endpoint(endpoint)
    port = server.add_insecure_port(target)
    server.bound_port = port  # type: ignore[attr-defined]
    server.start()
    return server
