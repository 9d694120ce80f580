"""The placement explainability plane (``tests/test_explain.py``): the
closed reason taxonomy, the vectorized attribution against its
brute-force oracle, the schedz ledger and the explain trace — run
against the port."""

from test_torch_twins import load_twin

globals().update(load_twin("test_explain"))
