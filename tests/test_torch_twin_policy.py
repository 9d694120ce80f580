"""The placement policy (``tests/test_policy.py``): class resolution, DRF
fair-share ordering, effective-priority encoding, the preemption-pool
filter, the backfill pass and its guard fuzz, the dirty-gated fair-share
save, the simulator's policy scenarios and the fair-share state's
persistence — run against the port. None is dropped."""

from test_torch_twins import load_twin

globals().update(load_twin("test_policy"))
