"""The Slurm dialect parsers' tests (``tests/test_core_parsers.py``), run
against the port's copies (``core/durations``, ``timeparse``,
``hostlist``, ``scontrol``, ``sbatch``, ``sacct``)."""

from test_torch_twins import load_twin

globals().update(load_twin("test_core_parsers"))
