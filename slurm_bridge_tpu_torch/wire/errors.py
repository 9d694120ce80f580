"""The RPC failure the placement tick catches.

The JAX package catches ``grpc.RpcError``. The card's machine has no
``grpc``, and the in-process tick needs none, so the port raises and
catches this class instead: the same two accessors (``code()`` and
``details()``) and a :class:`StatusCode` whose member names are grpc's.
"""

from __future__ import annotations

import enum


class StatusCode(enum.Enum):
    """The gRPC status codes, by grpc's names and numbers."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class RpcError(Exception):
    """An RPC that did not complete: ``code()`` says why, ``details()``
    carries the server's message."""

    def __init__(self, code: StatusCode = StatusCode.UNKNOWN, details: str = ""):
        super().__init__(f"{code.name}: {details}" if details else code.name)
        self._code = code
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details
