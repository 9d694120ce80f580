"""mirror_sweep_ms: the operator's owner sweep in the mirror, with the
reconciles it settles (`operator.sweep`), window mean per tick."""

from bblib.parts import part_mean


def read(run):
    return part_mean(run, "mirror.sweep")
