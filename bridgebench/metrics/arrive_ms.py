"""arrive_ms: the phase clock's "arrive" time, window mean per tick."""

from bblib.readers import tick_mean


def read(run):
    return tick_mean(run, "arrive")
