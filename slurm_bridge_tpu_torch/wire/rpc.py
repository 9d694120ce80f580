"""The agent RPCs' method table and bounded retries, without grpc.

The JAX package derives gRPC stubs and servicers from the protobuf
descriptor at runtime (``wire/rpc.py``). The card's machine has neither
``grpc`` nor ``protobuf``, and the simulator's agent is an object in the
same process, so the port keeps the parts of that module that need no
transport: the per-service method table (:func:`service_methods`, read
from the port's own schema in :mod:`~slurm_bridge_tpu_torch.wire.messages`)
and the bounded retry wrapper (:class:`RetryPolicy`,
:func:`call_with_retries`, :class:`RetryingClient`), which catches the
port's :class:`~slurm_bridge_tpu_torch.wire.errors.RpcError`. ``dial``,
the channel-backed ``ServiceClient``, ``serve`` and ``generic_handler``
come with the gRPC transport.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass

from slurm_bridge_tpu_torch.wire import messages as pb
from slurm_bridge_tpu_torch.wire.errors import RpcError


@dataclass(frozen=True)
class MethodSpec:
    name: str
    request_streaming: bool
    response_streaming: bool
    req_cls: type
    resp_cls: type


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
