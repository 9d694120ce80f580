"""backfill_ms: the policy's second pass after the solve (the
`policy.backfill` span inside "other", with counters `candidates` and
`takes`), window mean per tick."""

from bblib.parts import part_mean


def read(run):
    return part_mean(run, "policy.backfill")
