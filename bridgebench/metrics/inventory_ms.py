"""inventory_ms: the scheduler's inventory RPCs (the `scheduler.store.inventory`
span inside "store"), window mean per tick."""

from bblib.parts import part_mean


def read(run):
    return part_mean(run, "store.inventory")
