"""The event-driven incremental tick (``tests/test_incremental.py``): off
reproduces the pre-change fixture, on equals off across arrival, drain
and fault shapes, and the dirty-set bookkeeping — run against the port."""

from test_torch_twins import load_twin

globals().update(load_twin("test_incremental"))
