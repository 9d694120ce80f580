"""Shared sentinel-tolerant timestamp parsing for Slurm text output.

scontrol and sacct both render ISO-8601 local timestamps with a family of
null sentinels; this is the one place that knows the full sentinel set.
"""

from __future__ import annotations

from datetime import datetime

NULL_SENTINELS = {"", "(null)", "N/A", "n/a", "None", "NONE", "Unknown", "UNKNOWN"}


def parse_slurm_time(v: str) -> datetime | None:
    """Parse a Slurm timestamp (`2024-03-12T09:41:02`); sentinels → None."""
    s = v.strip()
    if s in NULL_SENTINELS:
        return None
    try:
        return datetime.fromisoformat(s)
    except ValueError:
        return None
