"""store_ms.steady: store_ms over a steady window."""

from bblib.readers import steady_only, tick_mean


def read(run):
    return steady_only(run, tick_mean(run, "store"))
