"""host_syncs: the points at which the solve read a device result on the
host (the `host_syncs` counter of `scheduler.solve`), window mean per tick."""

from bblib.parts import part_mean


def read(run):
    return part_mean(run, "solve.host_syncs")
