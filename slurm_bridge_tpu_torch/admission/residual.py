"""The residual free_after view the fast path admits against.

One :class:`ResidualView` holds the capacity picture the last batch
solve left behind — ``placement.free_after`` after backfill, on the
tick's global node axis — plus the snapshot columns (partition codes,
feature masks, node names) needed to answer "where does one shard of
this demand fit" without any RPC or re-encode.

The view is maintained **incrementally**: the batch tick re-bases it
once per solve (``begin_window``), and every fast-path bind between
ticks subtracts its demand in place (``apply_bind``). It is never
rebuilt per admission — an admission is a masked vector compare over
the partition's nodes, O(partition), typically microseconds.

Staleness discipline: between SOLVE rebases the window only ever
*understates* free capacity — a fit in the view is a fit in the model
the guarded backfill would have used, the conservative direction — and
a miss falls through to the normal pending scan untouched. Since ISSUE
15 (ROADMAP streaming-admission follow-up c) an idle cluster's window
is additionally maintained from the provider's periodic inventory probe
(:meth:`~slurm_bridge_tpu_torch.admission.fastpath.FastPathAdmitter.rebase_from_inventory`),
so capacity freed by completions re-opens to the fast path without
waiting for a solve that — with nothing pending — would never come; the
scheduler gates that path to ticks where no solve re-based the window,
keeping the solve's own residual authoritative.
"""

from __future__ import annotations

import numpy as np

from slurm_bridge_tpu_torch.policy.engine import feasible_nodes


class ResidualView:
    """Residual free capacity on the last solve's node axis."""

    def __init__(self) -> None:
        #: the ClusterSnapshot(-shaped) window: node_names, partition_of,
        #: features, partition_codes, feature_codes — shared read-only
        #: with the encoder caches; only ``free`` below is owned
        self.snapshot = None
        #: [N, 3] float32 residual free (cpu, mem, gpu) — OWNED copy,
        #: mutated in place by fast-path binds
        self.free: np.ndarray | None = None
        #: bumped per re-base — observability + staleness assertions
        self.generation = 0
        #: fast-path binds applied since the last re-base
        self.binds_since_window = 0

    @property
    def ready(self) -> bool:
        return self.free is not None

    def begin_window(self, snapshot, free_after: np.ndarray) -> None:
        """Re-base on a fresh solve's post-backfill residual. The copy
        is the view's entire per-tick cost — everything else is shared
        by reference with the solve's own snapshot."""
        self.snapshot = snapshot
        self.free = np.array(free_after, np.float32, copy=True)
        self.generation += 1
        self.binds_since_window = 0

    def feasible(self, d: np.ndarray, part: int, req: int) -> np.ndarray:
        """Boolean node mask for one shard of ``d`` — the same
        :func:`policy.engine.feasible_nodes` rule guarded backfill uses."""
        s = self.snapshot
        return feasible_nodes(self.free, s.partition_of, s.features, d, part, req)

    def apply_bind(self, positions: list[int], d: np.ndarray) -> None:
        """Subtract one shard of ``d`` on each chosen node position —
        the one-shot form of the debit
        :meth:`~slurm_bridge_tpu_torch.admission.fastpath.FastPathAdmitter.admit`
        performs node-by-node DURING its guard walk (the guard must
        read each take before choosing the next node, so the admitter
        cannot batch through this method); kept as the maintenance seam
        for external window owners and the equivalence oracle
        (tests/test_admission.py). Both forms share the same invariant:
        ``free == base - Σ outstanding takes``."""
        for n in positions:
            self.free[n] -= d
        self.binds_since_window += 1

    def release(self, positions: list[int], d: np.ndarray) -> None:
        """Roll back one bind's debit (the store-bind conflict path —
        the admitter pairs it with restoring the guard bookkeeping)."""
        for n in positions:
            self.free[n] += d
        self.binds_since_window -= 1
