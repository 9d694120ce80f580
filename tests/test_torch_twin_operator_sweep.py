"""The operator's batched sweep against single-key reconciles
(``tests/test_operator_sweep.py``), run against the port's operator,
provider and simulated agent."""

from test_torch_twins import load_twin

globals().update(load_twin("test_operator_sweep"))
