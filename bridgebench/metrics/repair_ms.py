"""repair_ms: the solve's host-side exact repair (the `solve.repair` span
inside "solve"), window mean per tick."""

from bblib.parts import part_mean


def read(run):
    return part_mean(run, "solve.repair")
