"""Typed node/partition/job model and the Slurm array-spec grammar."""
