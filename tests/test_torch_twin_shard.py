"""Sharded placement (``tests/test_shard.py``): the plan, demand routing,
the cross-shard reconcile pass and the executor — its route to the
multi-device sweep on eight CPU blocks included — the sharding-off
fixture and a sharded scenario through the whole stack, run against the
port."""

from test_torch_twins import load_twin

globals().update(load_twin(
    "test_shard",
    rewrites=[
        # the port's grid takes its own devices: the eight CPU blocks the
        # twins stand in for the reference's eight virtual XLA devices
        ("    devices = jax.devices()\n",
         "    from slurm_bridge_tpu_torch.parallel.mesh import process_devices\n\n"
         '    devices = process_devices("cpu")\n'),
    ],
    eight_devices=True,
))
