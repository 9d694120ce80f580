"""``DeviceSolver`` (``tests/test_session.py``): a drop-in for
``auction_place`` minus the transfers, two solves in flight at once,
incumbents and snapshot updates — run against the port, with the feasibility
check taken from the twin of ``tests/test_solver.py``."""

from test_torch_twins import load_twin

globals().update(load_twin(
    "test_session",
    rewrites=[("from tests.test_solver import _check_feasible\n",
               "from test_torch_twin_solver import _check_feasible\n")],
))
