"""mirror_submit_ms: the tick thread's submit chunks in the mirror
(`vnode.submit_chunk`: encode and SubmitJobs), window mean per tick."""

from bblib.parts import part_mean


def read(run):
    return part_mean(run, "mirror.submit")
