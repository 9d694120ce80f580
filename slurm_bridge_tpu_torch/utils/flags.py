"""Flag value validators — argparse ``type=`` callables.

Reference parity: pkg/common/flag/flags.go:37-152, the pflag ``IPVar`` /
``IPPortVar`` / ``PortRangeVar`` validators the kubelet-style flag system
uses. Each raises ``argparse.ArgumentTypeError`` on bad input so argparse
renders the usage error, matching pflag's set-time validation.
"""

from __future__ import annotations

import argparse
import ipaddress


def ip_address(value: str) -> str:
    """A bare IPv4/IPv6 address (IPVar)."""
    try:
        ipaddress.ip_address(value)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{value!r} is not a valid IP address") from None
    return value


def ip_port(value: str) -> str:
    """``ip:port`` or bare ``port`` (IPPortVar accepts both forms)."""
    host, sep, port = value.rpartition(":")
    if not sep:
        host, port = "", value
    elif not host:
        raise argparse.ArgumentTypeError(f"{value!r}: empty host before ':'")
    if host:
        h = host[1:-1] if host.startswith("[") and host.endswith("]") else host
        try:
            ipaddress.ip_address(h)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"{value!r}: {h!r} is not a valid IP address"
            ) from None
    try:
        p = int(port)
    except ValueError:
        raise argparse.ArgumentTypeError(f"{value!r}: port {port!r} is not a number") from None
    if not 1 <= p <= 65535:
        raise argparse.ArgumentTypeError(f"{value!r}: port {p} outside 1-65535")
    return value


def add_deprecated_flag(parser, name: str, *, dest: str, replacement: str, **kw):
    """Register ``name`` as a deprecated alias of ``replacement``.

    Reference parity: the VK's deprecated-flag machinery
    (cmd/slurm-virtual-kubelet/app/options/options.go:274-302) — the old
    spelling still parses into the same dest, but using it logs a warning
    naming the replacement.
    """
    import argparse
    import logging

    log = logging.getLogger("sbt.flags")

    class _Deprecated(argparse.Action):
        def __call__(self, _parser, namespace, values, option_string=None):
            log.warning(
                "flag %s is deprecated, use %s", option_string, replacement
            )
            setattr(namespace, dest, values if values is not None else True)

    nargs = kw.pop("nargs", None)
    parser.add_argument(
        name, dest=dest, action=_Deprecated, help=argparse.SUPPRESS,
        nargs=nargs, **kw,
    )


def port_range(value: str) -> tuple[int, int]:
    """``lo-hi`` (inclusive) or a single port (PortRangeVar)."""
    lo_s, sep, hi_s = value.partition("-")
    try:
        lo = int(lo_s)
        hi = int(hi_s) if sep else lo
    except ValueError:
        raise argparse.ArgumentTypeError(f"{value!r} is not a port range") from None
    if not (1 <= lo <= 65535 and 1 <= hi <= 65535):
        raise argparse.ArgumentTypeError(f"{value!r}: ports outside 1-65535")
    if hi < lo:
        raise argparse.ArgumentTypeError(f"{value!r}: range is inverted")
    return (lo, hi)
