"""The placement-solver sidecar (``tests/test_solver_service.py``): Place
over a unix socket with each engine, gangs, features, priorities,
incumbents, config overrides and auto-routing, and SolverInfo — run
against the port's servicer and transport."""

from test_torch_twins import GRPC_AS_PORT_ERRORS, load_twin

globals().update(load_twin(
    "test_solver_service",
    rewrites=[GRPC_AS_PORT_ERRORS],
    drop=[
        # the multi-device sweep (ROADMAP Queue 1 item 8) is not ported: a
        # Place naming it fails with UNIMPLEMENTED (tests/test_torch_service.py)
        "test_place_sharded_solver",
        # the bridge runtime (``bridge.Bridge``) and the agent's servicer
        # (``agent.WorkloadServicer``) these drive are not ported yet
        # (ROADMAP Queue 1 item 4, slice 7); tests/test_torch_service.py
        # drives PlacementScheduler(solver_endpoint=) against the sidecar
        "test_bridge_with_solver_sidecar",
        "test_bridge_survives_solver_sidecar_restart",
        "test_auto_bridge_routes_through_sidecar_to_indexed",
    ],
))
