"""Instruction counts of ``bid_argmax``'s cell loop, from its SASS.

Builds ``slurm_bridge_tpu_torch/csrc/bid_argmax.cu`` as the port builds it
(``ops/bid_argmax.py:build``), disassembles the library with
``cuobjdump -sass`` and, for each instantiation of the scoring kernel
(``bid_argmax_score<false>`` without the affinity term, ``<true>`` with
it), finds the cell loop — the longest body of a backward branch — and
counts its instructions by opcode and by the pipe that issues them. One
pass of the loop scores ``nodes`` staged nodes (its 16-byte shared loads
of node records, two per node and one more with affinity) against a
thread's ``kRowsPerThread`` rows, so each count divided by ``nodes`` ×
rows is per needed cell: what ``ops/bid_argmax.py``'s ``CELL_OPS`` and
``CELL_OPS_AFF`` hold and chip_smoke.py's bounds use. Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit); no card.

    python tools/port_sass.py
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import slurm_bridge_tpu_torch.ops.bid_argmax as kern  # noqa: E402

ROWS_PER_THREAD = 4  # kRowsPerThread of csrc/bid_argmax.cu
#: opcode (its first dot-separated part) → the pipe class CELL_OPS counts
PIPES = {
    "int": ("LOP3", "IMAD", "SHF", "ISETP", "PLOP3", "VIADD", "IADD3", "LEA", "SEL", "IMNMX",
            "SHL", "SHR", "IADD", "LOP", "ISCADD", "VIMNMX"),
    "f32": ("FSETP", "FMUL", "FADD", "FFMA", "FSEL", "FMNMX"),
    "cvt": ("I2F", "I2FP", "F2I", "F2F"),
    "lds": ("LDS",),
}


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")


def functions(sass: str) -> dict[str, list[tuple[int, str, str]]]:
    """Function name → its (address, opcode, text) instructions; branch
    labels resolved to the address of the instruction after them."""
    funcs: dict[str, list] = {}
    labels: dict[str, dict[str, int]] = {}
    cur, pending = None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur, pending = m.group(1), []
            funcs[cur], labels[cur] = [], {}
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr, text = int(m.group(1), 16), m.group(2).strip()
            for name in pending:
                labels[cur][name] = addr
            pending = []
            toks = text.split()
            op = toks[1] if toks[0].startswith("@") else toks[0]
            funcs[cur].append((addr, op, text))
    for name, ins in funcs.items():
        funcs[name] = [(a, op, _resolve(t, labels[name])) for a, op, t in ins]
    return funcs


def _resolve(text: str, labels: dict[str, int]) -> str:
    return re.sub(r"`\((\.L_x_\d+)\)", lambda m: hex(labels.get(m.group(1), -1)), text)


def cell_loop(ins: list[tuple[int, str, str]]) -> list[tuple[int, str, str]]:
    """The longest backward-branch body."""
    best: list = []
    for i, (addr, op, text) in enumerate(ins):
        if not op.startswith("BRA"):
            continue
        m = re.search(r"(0x[0-9a-f]+)\s*$", text)
        if not m:
            continue
        target = int(m.group(1), 16)
        if target < addr:
            body = [x for x in ins[: i + 1] if x[0] >= target]
            if len(body) > len(best):
                best = body
    return best


def main() -> None:
    out = kern.build(force=True)
    regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
    sass = subprocess.run([cuobjdump(), "-sass", str(kern._LIB)], capture_output=True,
                          text=True, check=True).stdout
    report = {"ptxas": regs}
    for name, ins in functions(sass).items():
        if "bid_argmax_score" not in name:
            continue
        aff = "ILb1E" in name
        body = cell_loop(ins)
        ops = collections.Counter(op for _, op, _ in body)
        lds128 = sum(n for op, n in ops.items() if op.startswith("LDS.128"))
        nodes = lds128 // (3 if aff else 2)
        cells = max(nodes, 1) * ROWS_PER_THREAD
        pipes = collections.Counter()
        for op, n in ops.items():
            base = op.split(".")[0]
            pipe = next((k for k, v in PIPES.items() if base in v), "other")
            pipes[pipe] += n
        report["score<true>" if aff else "score<false>"] = {
            "function": name, "loop_instructions": len(body), "nodes_per_pass": nodes,
            "rows_per_thread": ROWS_PER_THREAD, "by_pipe": dict(pipes),
            "per_cell": {k: v / cells for k, v in pipes.items()},
            "opcodes": dict(sorted(ops.items())),
        }
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
