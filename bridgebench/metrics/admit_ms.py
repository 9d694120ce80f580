"""admit_ms: the tick's arrival-time admission loop (the `sim.arrive.admit`
span inside "arrive": each fast-path-eligible arrival's `scheduler.admit`,
its bind included), window mean per tick."""

from bblib.parts import part_mean


def read(run):
    return part_mean(run, "arrive.admit")
