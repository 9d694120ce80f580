"""Sharded placement (``tests/test_shard.py``): the plan, demand routing,
the cross-shard reconcile pass and the executor, the sharding-off
fixture and a sharded scenario through the whole stack, run against the
port."""

from test_torch_twins import load_twin

globals().update(load_twin(
    "test_shard",
    drop=[
        # the multi-device sweep (ROADMAP Queue 1 item 8) is not ported,
        # and the port has no CPU fallback for a device solve by design:
        # tests/test_torch_shard.py holds what the port does instead
        "test_executor_device_sharded_route_with_cpu_fallback",
        "test_multichip_dp4_mp2_parity_at_least_90pct",
    ],
))
