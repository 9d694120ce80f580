"""Slurm job-array spec grammar.

Forms (sbatch(1) --array): "0-31", "1,3,5,7", "1-7:2" (step), and a
"%N" max-simultaneous suffix, composable: "0-15%4", "1,3,9-12%2".

Reference parity: parseArrayLen (pkg/slurm-bridge-operator/parse.go:126-135)
only counted a plain "a-b" range; we implement the full grammar since the
array length multiplies placement demand (pod.go:153-156).
"""

from __future__ import annotations

from typing import Iterator

#: Upper bound on task ids — slurm.conf MaxArraySize's own ceiling (slurm
#: caps array indices at 4M; the common default is 1001). Without it,
#: "--array=0-99999999" from a user script would materialize a
#: hundred-million-element list in the control plane (found by hypothesis,
#: tests/test_properties.py).
MAX_ARRAY_SIZE = 4_000_001

#: Expansion sizes up to this are counted exactly (set union over chunks);
#: beyond it, multi-chunk counts fall back to the per-chunk arithmetic sum
#: — a conservative upper bound when chunks overlap, but no multi-million
#: element set ever exists in the sizing hot path.
_EXACT_COUNT_LIMIT = 1 << 16


def _iter_chunks(spec: str) -> Iterator[tuple[int, int, int]]:
    """Yield (lo, hi, step) per comma-chunk — the ONE implementation of
    the --array grammar; expansion and counting both consume it."""
    s = spec.strip()
    if not s:
        return
    # strip %N throttle suffix (applies to the whole spec)
    if "%" in s:
        s, _, throttle = s.rpartition("%")
        if not throttle.isdigit():
            raise ValueError(f"bad array throttle in {spec!r}")
    for chunk in s.split(","):
        chunk = chunk.strip()
        if not chunk:
            raise ValueError(f"bad array spec {spec!r}")
        step = 1
        if ":" in chunk:
            chunk, _, step_s = chunk.partition(":")
            if not step_s.isdigit() or int(step_s) < 1:
                raise ValueError(f"bad array step in {spec!r}")
            step = int(step_s)
        if "-" in chunk:
            lo_s, _, hi_s = chunk.partition("-")
            if not (lo_s.isdigit() and hi_s.isdigit()):
                raise ValueError(f"bad array range in {spec!r}")
            lo, hi = int(lo_s), int(hi_s)
            if hi < lo:
                raise ValueError(f"inverted array range in {spec!r}")
        else:
            if not chunk.isdigit():
                raise ValueError(f"bad array id in {spec!r}")
            lo = hi = int(chunk)
        if hi >= MAX_ARRAY_SIZE:
            raise ValueError(
                f"array range in {spec!r} exceeds MaxArraySize "
                f"({MAX_ARRAY_SIZE - 1})"
            )
        yield lo, hi, step


def parse_array_spec(spec: str) -> list[int]:
    """Expand an --array spec into the sorted list of task ids."""
    ids: set[int] = set()
    for lo, hi, step in _iter_chunks(spec):
        ids.update(range(lo, hi + 1, step))
    return sorted(ids)


def _merged_count(chunks: list[tuple[int, int, int]]) -> int:
    """Count the union without materializing: chunks sharing (step, phase)
    are interval-merged exactly; only cross-step overlap (rare: mixed
    ":N" steps hitting the same ids) can still overcount."""
    from collections import defaultdict

    groups: dict[tuple[int, int], list[tuple[int, int]]] = defaultdict(list)
    for lo, hi, step in chunks:
        groups[(step, lo % step)].append((lo, hi))
    total = 0
    for (step, _), ranges in groups.items():
        ranges.sort()
        cur_lo, cur_hi = ranges[0]
        for lo, hi in ranges[1:]:
            if lo <= cur_hi + step:  # touching progressions merge
                cur_hi = max(cur_hi, hi)
            else:
                total += (cur_hi - cur_lo) // step + 1
                cur_lo, cur_hi = lo, hi
        total += (cur_hi - cur_lo) // step + 1
    return total


def array_len(spec: str) -> int:
    """Number of array tasks; 1 for the empty spec (non-array job).

    Counted arithmetically — the sizecar sizing hot path never
    materializes task ids for large legal specs. Same-step overlapping
    chunks are interval-merged exactly at any size (ADVICE r3:
    "0-70000,0-70000" must not double demand); small multi-chunk specs are
    counted exactly via set union (collapsing even cross-step duplicates,
    matching :func:`parse_array_spec`); only large specs with duplicate
    ids across *different* steps keep a conservative upper bound."""
    chunks = list(_iter_chunks(spec))
    if not chunks:
        return 1
    if len(chunks) == 1:
        lo, hi, step = chunks[0]
        return max(1, (hi - lo) // step + 1)
    # gate the set-union path on the ARITHMETIC sum — it equals the number
    # of range inserts the union performs, so duplicated chunks can't push
    # materialization work past the cap (the merged total undercounts it)
    raw_sum = sum((hi - lo) // step + 1 for lo, hi, step in chunks)
    if raw_sum <= _EXACT_COUNT_LIMIT:
        ids: set[int] = set()
        for lo, hi, step in chunks:
            ids.update(range(lo, hi + 1, step))
        return max(1, len(ids))
    return max(1, _merged_count(chunks))
