"""Slurm hostlist expression expansion/compression.

Expands `node[1-4,7]`, `tpu-[001-003]`, `a1,b[2-3]c` style expressions into
concrete host names (and back). The reference leaned on `scontrol show nodes
a,b,c` with pre-expanded names (pkg/slurm-agent/slurm.go:355-365,
parse.go:278-289); we expand locally so a 10k-node partition does not need a
second round-trip.
"""

from __future__ import annotations

import re

#: Refuse to expand beyond this many hosts — a hostile `node[1-10**10]`
#: must not OOM the agent.
MAX_HOSTS = 1_000_000


def expand_hostlist(expr: str) -> list[str]:
    """Expand a Slurm hostlist expression into a list of host names."""
    out: list[str] = []
    for part in _split_top(expr):
        out.extend(_expand_one(part))
        if len(out) > MAX_HOSTS:
            raise ValueError(f"hostlist expands past {MAX_HOSTS} hosts")
    return out


def _split_top(expr: str) -> list[str]:
    """Split on commas that are not inside brackets."""
    parts, depth, cur = [], 0, []
    for ch in expr:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
            if depth < 0:
                raise ValueError(f"unbalanced ] in hostlist {expr!r}")
        if ch == "," and depth == 0:
            if cur:
                parts.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if depth != 0:
        raise ValueError(f"unbalanced [ in hostlist {expr!r}")
    if cur:
        parts.append("".join(cur))
    return [p.strip() for p in parts if p.strip()]


_RANGE_RE = re.compile(r"^(\d+)-(\d+)$")


def _expand_one(part: str) -> list[str]:
    m = re.search(r"\[([^\]]*)\]", part)
    if not m:
        return [part]
    prefix, body, suffix = part[: m.start()], m.group(1), part[m.end() :]
    ids: list[str] = []
    for chunk in body.split(","):
        chunk = chunk.strip()
        rm = _RANGE_RE.match(chunk)
        if rm:
            lo_s, hi_s = rm.group(1), rm.group(2)
            width = len(lo_s) if lo_s.startswith("0") else 0
            lo, hi = int(lo_s), int(hi_s)
            if hi < lo:
                raise ValueError(f"inverted range in hostlist {part!r}")
            if hi - lo + 1 > MAX_HOSTS:
                raise ValueError(f"hostlist range {chunk!r} expands past {MAX_HOSTS} hosts")
            ids.extend(str(i).zfill(width) for i in range(lo, hi + 1))
        elif chunk.isdigit():
            ids.append(chunk)
        else:
            raise ValueError(f"bad hostlist range {chunk!r} in {part!r}")
    expanded = [f"{prefix}{i}{suffix}" for i in ids]
    # suffix may itself contain another bracket group (rare but legal);
    # cap the cross-product as it accumulates, not after materialising it
    if "[" in suffix:
        out: list[str] = []
        for e in expanded:
            out.extend(_expand_one(e))
            if len(out) > MAX_HOSTS:
                raise ValueError(f"hostlist expands past {MAX_HOSTS} hosts")
        return out
    return expanded


def compress_hostlist(hosts: list[str]) -> str:
    """Compress host names back into a compact `prefix[a-b,...]` expression.

    Groups by (prefix, numeric-suffix width); non-conforming names pass
    through verbatim.
    """
    groups: dict[tuple[str, int], list[int]] = {}
    passthrough: list[str] = []
    name_re = re.compile(r"^(.*?)(\d+)$")
    for h in hosts:
        m = name_re.match(h)
        if not m:
            passthrough.append(h)
            continue
        prefix, num = m.group(1), m.group(2)
        width = len(num) if num.startswith("0") else 0
        groups.setdefault((prefix, width), []).append(int(num))
    parts: list[str] = []
    for (prefix, width), nums in groups.items():
        nums = sorted(set(nums))
        ranges: list[str] = []
        start = prev = nums[0]
        for n in nums[1:] + [None]:  # type: ignore[list-item]
            if n is not None and n == prev + 1:
                prev = n
                continue
            lo = str(start).zfill(width)
            hi = str(prev).zfill(width)
            ranges.append(lo if start == prev else f"{lo}-{hi}")
            if n is not None:
                start = prev = n
        if len(ranges) == 1 and "-" not in ranges[0]:
            parts.append(f"{prefix}{ranges[0]}")
        else:
            parts.append(f"{prefix}[{','.join(ranges)}]")
    parts.extend(passthrough)
    return ",".join(parts)
