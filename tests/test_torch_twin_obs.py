"""The observability tests (``tests/test_obs.py``): metrics, tracing and
its gRPC interceptor, the OTLP exporter, leader-election metrics and the
profiler, run against the port's ``obs`` modules."""

from test_torch_twins import load_twin

globals().update(load_twin(
    "test_obs",
    rewrites=[
        ("from slurm_bridge_tpu_torch.wire import workload_pb2 as pb\n",
         "from slurm_bridge_tpu_torch.wire import pb\n"),
    ],
))
