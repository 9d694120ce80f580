"""mirror_status_ms: the tick thread's status reads in the mirror
(`vnode.status`, and `sim.mirror.fetch_wait` for the overlapped fetch),
window mean per tick."""

from bblib.parts import part_mean


def read(run):
    return part_mean(run, "mirror.status")
