"""The fleet (``tests/test_fleet.py``): PlaceShard's columnar framing and
the schema handshake, the membership table and its re-keying, sidecar
processes solving over gRPC, dying and being re-adopted, and the fleet
scenarios through the simulator — run against the port, whose sidecars
are ``python -m slurm_bridge_tpu_torch.fleet.worker`` processes."""

from test_torch_twins import load_twin

#: the port's schema is its own message table, not ``workload_pb2``
PB_AS_PORT_MESSAGES = (
    "from slurm_bridge_tpu_torch.wire import workload_pb2 as pb\n",
    "from slurm_bridge_tpu_torch.wire import messages as pb\n",
)

globals().update(load_twin(
    "test_fleet", rewrites=[PB_AS_PORT_MESSAGES]
))
