"""The placement-solver sidecar (``tests/test_solver_service.py``): Place
over a unix socket with each engine, gangs, features, priorities,
incumbents, config overrides and auto-routing, SolverInfo, and a
``Bridge`` ticking through the sidecar — run against the port's servicer,
transport and ``Bridge``."""

from test_torch_twins import GRPC_AS_PORT_ERRORS, load_twin

globals().update(load_twin(
    "test_solver_service",
    rewrites=[GRPC_AS_PORT_ERRORS],
    drop=[
        # the multi-device sweep (ROADMAP Queue 1 item 8) is not ported: a
        # Place naming it fails with UNIMPLEMENTED (tests/test_torch_service.py)
        "test_place_sharded_solver",
    ],
))
