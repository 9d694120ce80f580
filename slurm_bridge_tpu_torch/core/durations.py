"""Slurm duration grammar.

Accepted forms (sbatch(1) --time):
  "minutes", "minutes:seconds", "hours:minutes:seconds",
  "days-hours", "days-hours:minutes", "days-hours:minutes:seconds"
plus the sentinels "UNLIMITED", "INFINITE", "NOT_SET", and "N/A".

Reference parity: pkg/slurm-agent/parse.go:38-109 (ParseDuration incl. the
`d-h:m:s` form and an UNLIMITED sentinel error). We normalise sentinels to
``UNLIMITED`` (-1) via :class:`UnlimitedError` carrying that value, because the
solver clamps them into matrix headroom rather than propagating errors.
"""

from __future__ import annotations

import re

from slurm_bridge_tpu_torch.core.types import UNLIMITED

_SENTINELS = {"UNLIMITED", "INFINITE", "NOT_SET", "N/A", "NONE"}

_DAYS_RE = re.compile(
    r"^(?P<days>\d+)-(?P<hours>\d+)(?::(?P<mins>\d+))?(?::(?P<secs>\d+))?$"
)


class UnlimitedError(ValueError):
    """Raised for UNLIMITED/INFINITE inputs; carries the sentinel value."""

    def __init__(self, raw: str):
        super().__init__(f"duration is unlimited: {raw!r}")
        self.value = UNLIMITED


def parse_duration(raw: str, *, unlimited_ok: bool = True) -> int:
    """Parse a Slurm duration to whole seconds.

    With ``unlimited_ok`` (default) the UNLIMITED family returns the
    ``UNLIMITED`` sentinel (-1); otherwise :class:`UnlimitedError` is raised.
    """
    s = raw.strip()
    if not s:
        raise ValueError("empty duration")
    if s.upper() in _SENTINELS:
        if unlimited_ok:
            return UNLIMITED
        raise UnlimitedError(raw)

    m = _DAYS_RE.match(s)
    if m:
        days = int(m.group("days"))
        hours = int(m.group("hours"))
        mins = int(m.group("mins") or 0)
        secs = int(m.group("secs") or 0)
        return ((days * 24 + hours) * 60 + mins) * 60 + secs

    parts = s.split(":")
    if not all(p.isdigit() for p in parts):
        raise ValueError(f"bad duration: {raw!r}")
    if len(parts) == 1:  # minutes
        return int(parts[0]) * 60
    if len(parts) == 2:  # minutes:seconds
        return int(parts[0]) * 60 + int(parts[1])
    if len(parts) == 3:  # hours:minutes:seconds
        return (int(parts[0]) * 60 + int(parts[1])) * 60 + int(parts[2])
    raise ValueError(f"bad duration: {raw!r}")


def format_duration(seconds: int) -> str:
    """Render seconds in Slurm's canonical `[d-]hh:mm:ss` form."""
    if seconds == UNLIMITED:
        return "UNLIMITED"
    if seconds < 0:
        raise ValueError(f"negative duration: {seconds}")
    days, rem = divmod(seconds, 86400)
    hours, rem = divmod(rem, 3600)
    mins, secs = divmod(rem, 60)
    if days:
        return f"{days}-{hours:02d}:{mins:02d}:{secs:02d}"
    return f"{hours:02d}:{mins:02d}:{secs:02d}"
