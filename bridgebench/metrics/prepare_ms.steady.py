"""prepare_ms.steady: the solve's inputs before dispatch (the
`scheduler.prepare` spans inside "other": policy pass, demand list,
warm-start key) over a steady window."""

from bblib.parts import steady_part_mean


def read(run):
    return steady_part_mean(run, "prepare")
