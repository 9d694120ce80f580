"""admit_p50_ms: the median of the window's published admit walls (each
fast-bound eligible arrival's `scheduler.admit` wall after the latency
warm-up, the tick's `arrive.admit.walls`); None where no tick publishes
one."""

import numpy as np


def read(run):
    walls = [w for t in run.ticks for w in t.get("arrive.admit.walls", ())]
    return float(np.percentile(walls, 50)) if walls else None
