"""The bridge's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 bridgebench/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout with one CUDA card per chip the cell asks for.
Set-up (imports, CUDA, the kernel's build, the simulated cluster and its
trace, the warm ticks) runs first; then whole reconcile ticks for ``S``
seconds; then the plain reference judges every decision of the run. Prints
an earlier JSON line (set-up split, window wall against the bridge's
clock), then the result line; the numbers compared, each beside its limit,
close standard error. With ``--trace 1`` the metrics are the per-layer
ones, read under ``torch.profiler``; with ``--trace 0`` the end-to-end
ones. ``--control bfloat16`` scores the auction in bfloat16 (the check's
control: its result has to read not correct).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bfloat16",), default=None)
    args = ap.parse_args(argv)

    from bblib import cells, loop

    cell = cells.load(ROOT, args.workload)
    # the program's build and kernel caches stay inside the checkout
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(cache, "nv"))
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench: needs {cell.chips} CUDA device(s); "
              f"available={torch.cuda.is_available()} count={torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    result, early, checks, run = loop.run_cell(
        cell, seed=args.seed, seconds=args.seconds, traced=bool(args.trace),
        device="cuda", t0=T0, dtype=args.control,
    )
    found = loop.forbidden_modules()
    if found:
        print(f"bench: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    metrics = cell.per_layer if args.trace else cell.end_to_end
    for m in metrics:
        value = cells.reader(m["name"])(run)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    result["checks"] = checks.line()
    print(json.dumps(early), flush=True)
    for name, c in checks.items.items():
        print(f"check {name} = {c['value']} (limit {'<=' if c['kind'] == 'max' else '>='} "
              f"{c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
