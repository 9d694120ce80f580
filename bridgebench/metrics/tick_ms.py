"""tick_ms: the bridge clock of each window tick (arrive, store, encode,
solve, bind, mirror and the scheduler's other time) plus the collection
after it, summed over the window and divided by its ticks."""

from bblib.readers import tick_mean


def read(run):
    return tick_mean(run, "tick")
