"""pending_scan_ms: the scheduler's pending scan (the `scheduler.store.pending`
span inside "store"), window mean per tick."""

from bblib.parts import part_mean


def read(run):
    return part_mean(run, "store.pending")
