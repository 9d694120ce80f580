"""#SBATCH header scanner.

Extracts resource directives from a batch script's header block so the bridge
can size a placement request before the script ever reaches Slurm.

Reference parity: extractBatchResourcesFromScript
(pkg/slurm-bridge-operator/parse.go:30-124) handled --time/-t, --nodes/-N,
--mem-per-cpu, --ntasks-per-node, --cpus-per-task/-c in both `=` and space
forms. We cover that set plus --ntasks/-n, --array/-a, --partition/-p,
--job-name/-J, --gres, --licenses/-L, --chdir/-D, since all of them feed the
solver's demand vector.
"""

from __future__ import annotations

import re
import shlex
from dataclasses import dataclass, field

from slurm_bridge_tpu_torch.core.arrays import array_len
from slurm_bridge_tpu_torch.core.durations import parse_duration
from slurm_bridge_tpu_torch.core.types import JobDemand

_DIRECTIVE_RE = re.compile(r"^#SBATCH\s+(?P<body>.+?)\s*$")

# long-option → (field, converter); short flags alias into the same fields.
_LONG_OPTS = {
    "time": ("time_limit_s", parse_duration),
    "nodes": ("nodes", int),
    "mem-per-cpu": ("mem_per_cpu_mb", "mem"),
    "ntasks-per-node": ("ntasks_per_node", int),
    "cpus-per-task": ("cpus_per_task", int),
    "ntasks": ("ntasks", int),
    "array": ("array", str),
    "partition": ("partition", str),
    "job-name": ("job_name", str),
    "gres": ("gres", str),
    "licenses": ("licenses", str),
    "chdir": ("working_dir", str),
    "priority": ("priority", int),
}

_SHORT_OPTS = {
    "t": "time",
    "N": "nodes",
    "c": "cpus-per-task",
    "n": "ntasks",
    "a": "array",
    "p": "partition",
    "J": "job-name",
    "L": "licenses",
    "D": "chdir",
}

_MEM_RE = re.compile(r"^(?P<num>\d+)(?P<unit>[KkMmGgTt]?)B?$")


def parse_mem_mb(raw: str) -> int:
    """Parse sbatch memory values (default unit MiB; K/M/G/T suffixes)."""
    m = _MEM_RE.match(raw.strip())
    if not m:
        raise ValueError(f"bad memory value: {raw!r}")
    num = int(m.group("num"))
    unit = m.group("unit").upper() or "M"
    scale = {"K": 1 / 1024, "M": 1, "G": 1024, "T": 1024 * 1024}[unit]
    return int(num * scale)


@dataclass
class SbatchDirectives:
    """The parsed directive set plus anything we didn't recognise."""

    demand: JobDemand = field(default_factory=JobDemand)
    unknown: list[str] = field(default_factory=list)

    @property
    def array_count(self) -> int:
        return array_len(self.demand.array)


def _tokenize_directive(body: str) -> list[tuple[str, str | None]]:
    """Split one `#SBATCH` body into (option, value) pairs.

    Handles `--opt=v`, `--opt v`, `-x v`, `-xv`, quoted values
    (`--job-name="my job"`), and flag-only options. Trailing `# comments`
    are stripped, matching sbatch.
    """
    out: list[tuple[str, str | None]] = []
    try:
        toks = shlex.split(body, comments=True)
    except ValueError:  # unbalanced quotes: degrade to whitespace split
        toks = body.split()
    i = 0
    while i < len(toks):
        tok = toks[i]
        if tok.startswith("--"):
            name = tok[2:]
            if "=" in name:
                name, _, val = name.partition("=")
                out.append((name, val))
            elif i + 1 < len(toks) and not toks[i + 1].startswith("-"):
                out.append((name, toks[i + 1]))
                i += 1
            else:
                out.append((name, None))
        elif tok.startswith("-") and len(tok) > 1:
            short = tok[1]
            if len(tok) > 2:  # -c4 / -t10:00 attached form
                val = tok[2:]
                if val.startswith("="):
                    val = val[1:]
                out.append((_SHORT_OPTS.get(short, short), val))
            elif i + 1 < len(toks) and not toks[i + 1].startswith("-"):
                out.append((_SHORT_OPTS.get(short, short), toks[i + 1]))
                i += 1
            else:
                out.append((_SHORT_OPTS.get(short, short), None))
        i += 1
    return out


def extract_batch_resources(script: str) -> SbatchDirectives:
    """Scan a batch script's `#SBATCH` header block into a JobDemand.

    Scanning stops at the first non-blank, non-comment line after the shebang,
    matching sbatch's own semantics.
    """
    result = SbatchDirectives()
    demand = result.demand
    demand.script = script
    for lineno, line in enumerate(script.splitlines()):
        stripped = line.strip()
        if lineno == 0 and stripped.startswith("#!"):
            continue
        if not stripped:
            continue
        if not stripped.startswith("#"):
            break  # first command line: header block over
        m = _DIRECTIVE_RE.match(stripped)
        if not m:
            continue  # plain comment
        for name, val in _tokenize_directive(m.group("body")):
            spec = _LONG_OPTS.get(name)
            if spec is None:
                result.unknown.append(name if val is None else f"{name}={val}")
                continue
            field_name, conv = spec
            if val is None:
                result.unknown.append(name)
                continue
            try:
                if conv == "mem":
                    setattr(demand, field_name, parse_mem_mb(val))
                else:
                    setattr(demand, field_name, conv(val))
            except ValueError:
                result.unknown.append(f"{name}={val}")
    return result
