"""The resilience tests (``tests/test_resilience.py``): an agent restart
under a running ``Bridge``, run against the port."""

from test_torch_twins import load_twin

globals().update(load_twin("test_resilience"))
