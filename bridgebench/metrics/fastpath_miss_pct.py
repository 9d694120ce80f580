"""fastpath_miss_pct: 100 x the window's fast-path misses (every reason)
over its eligible attempts, from the counters of the `sim.arrive.admit`
spans; None where no tick carries them or nothing was attempted."""

MISS = "arrive.admit.miss_"


def read(run):
    if not any("arrive.admit.attempts" in t for t in run.ticks):
        return None
    attempts = sum(t.get("arrive.admit.attempts", 0.0) for t in run.ticks)
    if attempts <= 0:
        return None
    misses = sum(v for t in run.ticks for k, v in t.items() if k.startswith(MISS))
    return 100.0 * misses / attempts
