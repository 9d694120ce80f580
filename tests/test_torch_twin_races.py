"""The concurrency tests (``tests/test_races.py``): informers, the work
queue, optimistic concurrency and the provider's parallel pod sync
against a live agent, run against the port."""

from test_torch_twins import load_twin

globals().update(load_twin("test_races"))
