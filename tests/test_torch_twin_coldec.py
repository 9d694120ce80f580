"""The vectorized wire→column decoder's tests (``tests/test_coldec.py``),
run against the port: ``coldec`` is held to the port's own codec (its
``FromString`` plays pb2's part) and to the simulated agent's hand
serializers, and its tables to the port's message schema. The pre-change
fixture is reproduced by ``tests/test_torch_sim.py``."""

from test_torch_twins import GRPC_AS_PORT_ERRORS, load_twin

globals().update(load_twin(
    "test_coldec",
    rewrites=[GRPC_AS_PORT_ERRORS],
    drop=[
        # slow-marked in the reference; the fixture it pins runs in
        # tests/test_torch_sim.py::test_port_reproduces_off_baseline
        "test_coldec_off_matches_pre_change_fixture",
    ],
))
