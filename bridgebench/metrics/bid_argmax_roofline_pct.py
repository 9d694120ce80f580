"""bid_argmax_roofline_pct: over the window's calls of the scoring
kernel, the least time the card could take (bblib/roofline.py: operations
of the plain formula at the needed cells over the float32 peak, or bytes
over the memory bandwidth, whichever is larger) over the device time of
the kernels the calls launched."""

from bblib import roofline


def read(run):
    p = run.profile
    if not p or not run.launches:
        return None
    device_s = sum(s for name, s in p["device_ops"] if "bid_argmax" in name)
    if device_s <= 0:
        return None
    least = sum(roofline.least_seconds(*roofline.call_count(*c)) for c in run.launches)
    return 100.0 * least / device_s
