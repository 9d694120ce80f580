"""Cross-shard gang reconciliation — the second chance for gangs no
single shard could place.

A gang is routed whole to one shard (planner docstring), but a split
partition's free capacity may be scattered: shard A holds 3 feasible
nodes, shard B holds 2, and a 4-node gang fails in both even though the
PARTITION can host it. After every shard has solved, this pass re-solves
exactly those gangs against the merged residual-capacity view — the
per-shard ``free_after`` arrays scattered back onto the global node
axis — under the same rules as the policy backfill pass:

- **all-or-nothing**: a gang places completely or not at all (tentative
  takes roll back);
- **tightest-fit** node choice (least cpu headroom after placement), so
  reconciled gangs consume fragmentation instead of creating it;
- the **no-delay guard**: an assignment may not shrink the feasible node
  set of another still-unplaced equal-or-higher-rank gang below its
  size — reconciliation never trades a higher-priority gang's feasible
  start for a lower one's.

Candidates are processed rank-major (class rank desc, effective priority
desc, job index asc) and capped at ``limit`` per tick, mirroring the
backfill bounds. Everything is NumPy over per-partition member arrays —
the pass scales with failed gangs × partition size, not cluster size.
"""

from __future__ import annotations

import numpy as np


def reconcile_gangs(
    candidates: list[dict],
    free: np.ndarray,
    features: np.ndarray,
    part_nodes: dict[str, np.ndarray],
    *,
    limit: int = 512,
    node_tries: int = 8,
) -> list[tuple[int, list[int]]]:
    """Place failed gangs against the merged residual view.

    ``candidates``: one dict per fully-unplaced gang —
    ``{"j": global job index, "d": per-shard demand [3], "need": shard
    count, "part": partition name, "req": feature mask, "rank": class
    rank, "prio": effective priority}``. ``free`` is the global [N, 3]
    residual (mutated in place for every accepted gang); ``features``
    the global uint32 feature-mask column; ``part_nodes`` the planner's
    partition → member-position arrays.

    Returns ``(job index, chosen global node positions)`` per placed
    gang.
    """
    cands = sorted(
        candidates, key=lambda c: (-c["rank"], -c["prio"], c["j"])
    )[: max(0, limit)]

    def feas_mask(c, m):
        return ((free[m] >= c["d"]).all(axis=1)) & (
            (np.uint32(c["req"]) & ~features[m]) == 0
        )

    # protected set: gangs feasible NOW — their start must survive the
    # pass (the no-delay guard, same as policy/engine.py backfill)
    for c in cands:
        m = part_nodes.get(c["part"])
        if m is None or m.size < c["need"]:
            c["mask"] = None
            continue
        c["m"] = m
        c["mask"] = feas_mask(c, m)
        c["count"] = int(c["mask"].sum())
    protected = [c for c in cands if c["mask"] is not None and c["count"] >= c["need"]]

    out: list[tuple[int, list[int]]] = []
    for c in cands:
        if c["mask"] is None:
            continue
        m, d, need, rank = c["m"], c["d"], c["need"], c["rank"]
        fit = feas_mask(c, m)
        slots = np.nonzero(fit)[0]
        if slots.size < need:
            continue
        # tightest fit first: least cpu headroom after placement
        slots = slots[np.argsort(free[m[slots], 0] - d[0], kind="stable")]
        chosen: list[int] = []  # member-local positions
        hits: list = []  # (protected gang, member-local pos) reductions
        rolled = False
        for s in slots[: max(need, node_tries)].tolist():
            n = int(m[s])
            bad = False
            n_hits = []
            for g in protected:
                if g is c or g["rank"] < rank:
                    continue
                # g's mask is over ITS member array; same partition ⇒
                # same array, so the local index transfers directly
                if g["part"] != c["part"] or not g["mask"][s]:
                    continue
                if not (free[n] - d >= g["d"]).all():
                    if g["count"] - 1 < g["need"]:
                        bad = True
                        break
                    n_hits.append((g, s))
            if bad:
                continue
            free[n] -= d
            for g, gs in n_hits:
                g["mask"] = g["mask"].copy()
                g["mask"][gs] = False
                g["count"] -= 1
            hits.extend(n_hits)
            chosen.append(s)
            if len(chosen) == need:
                break
        if len(chosen) < need:
            # all-or-nothing: roll the tentative takes back (restoring
            # free restores exactly the feasibility each hit recorded)
            for s in chosen:
                free[int(m[s])] += d
            for g, gs in hits:
                g["mask"] = g["mask"].copy()
                g["mask"][gs] = True
                g["count"] += 1
            rolled = True
        if rolled:
            continue
        if c in protected:
            protected.remove(c)  # it started; nothing left to guard
        out.append((c["j"], [int(m[s]) for s in chosen]))
    return out
