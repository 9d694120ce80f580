"""chip_smoke.py's simulator phases alone on the card, each run to its end.

    python3 tools/port_phases.py [sim] [shard] [storm] [quality] [fault]

Builds the kernel, then runs phase [6] (``sim``: ``full_50kx10k_steady``),
[8] (``shard``: ``full_500kx100k_steady``, with its deadline lifted),
[14] (``storm``: ``interactive_storm`` at scale 40 and its admission-off
twin), [15] (``quality``: the placement-quality arms) and [16]
(``fault``: the fault gates) — all five by default — with every check
chip_smoke.py makes, going on to the next
phase when one fails. After phases [6] and [8] it prints the flight
record's span tree of ticks 3-5 (the last solving tick and the steady
ticks): where a steady tick's time goes, down to each span's counters.
Exits non-zero when a phase failed or there is no card. A few minutes of
card time where the whole of chip_smoke.py takes about a quarter hour.
"""

from __future__ import annotations

import os
import sys
import time
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PHASES = {
    "sim": lambda kern, smi: cs.sim_phase(kern, smi),
    "shard": lambda kern, smi: cs.shard_phase(kern, smi, sm_hz=1.98e9),
    "storm": lambda kern, smi: cs.storm_phase(kern, smi),
    "quality": lambda kern, smi: cs.quality_phase(kern, smi),
    "fault": lambda kern, smi: cs.fault_phase(kern, smi),
}
#: the ticks whose span trees print: the last solving tick, the steady ones
TREE_TICKS = range(3, 6)


def span_lines(name: str, node: dict, depth: int, out: list) -> None:
    if node["ms"] < 0.3 and depth > 1:
        return
    counters = node.get("counters") or ""
    out.append("  " * depth + f"{name}: {node['ms']:.1f} ms x{node['count']} {counters}")
    for child, sub in sorted(node.get("children", {}).items(), key=lambda kv: -kv[1]["ms"]):
        span_lines(child, sub, depth + 1, out)


def main() -> int:
    if not torch.cuda.is_available():
        print("port_phases: no CUDA device available", file=sys.stderr)
        return 2
    import slurm_bridge_tpu_torch.ops.bid_argmax as kern

    runs = []
    real_run_sim = cs.run_sim

    def run_sim(*a, **kw):
        runs.append(real_run_sim(*a, **kw))
        return runs[-1]

    cs.run_sim = run_sim
    cs.SHARD_DEADLINE_S = float("inf")
    smi = cs.smi_line()
    cs.log(f"{smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    kern.build(force=True)
    rc = 0
    for name in sys.argv[1:] or list(PHASES):
        kern.LAUNCHES = 0
        runs.clear()
        t0 = time.perf_counter()
        try:
            out = PHASES[name](kern, smi)
            cs.log(f"PHASE {name} OK: steady {out.get('steady')}, kernel launches {kern.LAUNCHES}")
        except Exception:
            rc = 1
            cs.log(f"PHASE {name} FAILED:\n{traceback.format_exc()}")
        cs.log(f"PHASE {name} wall {time.perf_counter() - t0:.1f} s [{smi}]")
        if name in ("sim", "shard") and runs:
            flight = runs[0]["harness"].flight
            for t in TREE_TICKS:
                rec, out = flight.records[t], []
                for root, node in rec["tree"].items():
                    span_lines(root, node, 0, out)
                cs.log(f"=== tick {t}: span total {rec['total_ms']:.1f} ms [{smi}]\n" + "\n".join(out))
    return rc


if __name__ == "__main__":
    sys.exit(main())
