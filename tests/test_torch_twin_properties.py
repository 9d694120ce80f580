"""Property-based tests (``tests/test_properties.py``, hypothesis) of the
parser layer and the solver invariants — run against the port."""

from test_torch_twins import load_twin

globals().update(load_twin("test_properties"))
