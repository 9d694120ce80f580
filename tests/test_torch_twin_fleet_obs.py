"""Fleet observability (``tests/test_fleet_obs.py``): PlaceShard trace
stitching, the client-span hook registry, the lifecycle timeline, the
federated sidecar counters and the colpool workers' self-timing — run
against the port, with its own messages and the port twins' helpers."""

from test_torch_twin_fleet import PB_AS_PORT_MESSAGES
from test_torch_twins import load_twin

globals().update(load_twin(
    "test_fleet_obs",
    rewrites=[
        PB_AS_PORT_MESSAGES,
        ("from tests.test_fleet import _Clock, _shape\n",
         "from test_torch_twin_fleet import _Clock, _shape\n"),
        ("    from tests.test_coldec import _random_response\n",
         "    from test_torch_twin_coldec import _random_response\n"),
    ],
))
