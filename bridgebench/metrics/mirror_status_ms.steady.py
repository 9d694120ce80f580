"""mirror_status_ms.steady: mirror_status_ms over a steady window."""

from bblib.parts import steady_part_mean


def read(run):
    return steady_part_mean(run, "mirror.status")
