"""The bridge's tests (``tests/test_bridge.py``): objects, the store, the
work queue, the status map, and the ``Bridge`` runtime walking jobs
through the fake Slurm shim over gRPC, run against the port."""

from test_torch_twins import load_twin

globals().update(load_twin("test_bridge"))
