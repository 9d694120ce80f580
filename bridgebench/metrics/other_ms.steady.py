"""other_ms.steady: other_ms over a steady window."""

from bblib.readers import steady_only, tick_mean


def read(run):
    return steady_only(run, tick_mean(run, "other"))
