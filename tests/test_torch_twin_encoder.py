"""The cross-tick encode caches (``tests/test_encoder.py``): delta
refresh, identity reuse, job-row carry-forward and the invalidation rules
— run against the port."""

from test_torch_twins import load_twin

globals().update(load_twin("test_encoder"))
