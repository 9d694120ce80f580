"""Statistical stack profiler behind ``/debug/profilez``.

Reference parity: the virtual-kubelet binary exposes Go's pprof by
side-effect import (the reference's cmd/slurm-virtual-kubelet/app/options/
options.go:30 ``_ "net/http/pprof"``), so an operator can ask a live
process where it is spending time. The Python rebuild's counterpart is a
py-spy-style sampler over ``sys._current_frames()``: GET /debug/profilez
samples every thread's stack for a short window and returns collapsed
stacks (most-sampled first) as text — enough to spot a wedged tick or a
hot loop without attaching a debugger to the pod.

Sampling, not tracing: safe on a live bridge (no sys.settrace overhead —
the cost is ~duration/interval stack walks) and it sees ALL threads,
including the reconcile/pod-sync workers and the gRPC executor.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import Counter

#: GET handlers cannot carry query params through the metrics server's
#: prefix routes, so the window is env-tuned; 2 s catches anything hot.
DEFAULT_SECONDS = 2.0
DEFAULT_INTERVAL = 0.01


def sample_profile(
    duration_s: float | None = None, interval_s: float = DEFAULT_INTERVAL
) -> str:
    """Sample all thread stacks for ``duration_s``; collapsed-stack text."""
    if duration_s is None:
        try:
            duration_s = float(os.environ.get("SBT_PROFILE_SECONDS", ""))
        except ValueError:
            duration_s = DEFAULT_SECONDS
        if not duration_s or duration_s <= 0:
            duration_s = DEFAULT_SECONDS
    me = threading.get_ident()
    stacks: Counter[tuple[str, ...]] = Counter()
    samples = 0
    t_end = time.monotonic() + duration_s
    while time.monotonic() < t_end:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue  # the profiler sampling itself is noise
            stack = []
            f = frame
            while f is not None:
                code = f.f_code
                stack.append(
                    f"{code.co_name} ({os.path.basename(code.co_filename)}"
                    f":{f.f_lineno})"
                )
                f = f.f_back
            stacks[tuple(reversed(stack))] += 1
        samples += 1
        time.sleep(interval_s)
    lines = [
        f"profilez — {samples} samples over {duration_s:.1f}s "
        f"across {len(stacks)} distinct stacks",
        "",
    ]
    for stack, n in stacks.most_common(40):
        lines.append(f"{n:6d}  {';'.join(stack)}")
    return "\n".join(lines) + "\n"
