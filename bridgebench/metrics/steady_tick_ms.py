"""steady_tick_ms: tick_ms over a window that opens after the first tick
the harness calls steady (nothing arrived, bound, was preempted or
written)."""

from bblib.readers import steady_only, tick_mean


def read(run):
    return steady_only(run, tick_mean(run, "tick"))
