"""The multi-process bootstrap (``tests/test_distributed.py``): the Slurm
step's rendezvous spec, the idempotent single-process no-op, process-
spanning meshes, the scheduler's sharded route and auto-select, and the
sweep at scale — run against the port on eight CPU blocks."""

from test_torch_twins import load_twin

globals().update(load_twin(
    "test_distributed",
    drop=[
        # JAX-only: JAX_COORDINATOR_ADDRESS and jax.distributed.initialize;
        # the port's counterpart (torch's MASTER_ADDR rendezvous) is
        # tests/test_torch_distributed.py::test_init_resolution_order
        "test_jax_coordinator_env_calls_initialize",
        # JAX-only: its workers join jax.distributed with four virtual XLA
        # devices each; the port's two-rank gloo run is
        # tests/test_torch_distributed.py::test_two_process_gloo_sweep_matches_one_process
        "test_multiprocess_distributed_sharded_solve",
    ],
    eight_devices=True,
))
