"""Parser for `sacct -p -n -j <id> -o start,end,exitcode,state,jobid,jobname`.

Reference parity: parseSacctResponse (pkg/slurm-agent/parse.go:214-253) reads
pipe-separated rows of 7 fields (6 + trailing empty from the final `|`) and
parseTime (:255-268) tolerates the `Unknown` sentinel.
"""

from __future__ import annotations

from slurm_bridge_tpu_torch.core.timeparse import parse_slurm_time
from slurm_bridge_tpu_torch.core.types import JobStatus, JobStepInfo

# sacct prints times as ISO-8601 without zone, e.g. 2023-10-10T10:00:00
_FIELDS = ("start", "end", "exitcode", "state", "jobid", "jobname")


def _parse_exit_code(v: str) -> int:
    # sacct renders "rc:signal"
    head = v.split(":", 1)[0].strip()
    try:
        return int(head)
    except ValueError:
        return 0


def parse_sacct_steps(text: str) -> list[JobStepInfo]:
    """Parse sacct's pipe-separated step rows into JobStepInfo records."""
    steps: list[JobStepInfo] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        cols = line.split("|")
        # trailing '|' yields an empty last column — the reference required
        # exactly 7 columns (parse.go:222-227); we accept 6 or 7.
        if cols and cols[-1] == "":
            cols = cols[:-1]
        if len(cols) != len(_FIELDS):
            raise ValueError(f"bad sacct row (want {len(_FIELDS)} cols): {line!r}")
        start, end, exitcode, state, jobid, jobname = cols
        steps.append(
            JobStepInfo(
                id=jobid.strip(),
                name=jobname.strip(),
                start_time=parse_slurm_time(start),
                finish_time=parse_slurm_time(end),
                exit_code=_parse_exit_code(exitcode),
                state=JobStatus.from_slurm(state),
            )
        )
    return steps
