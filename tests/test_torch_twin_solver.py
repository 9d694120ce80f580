"""Solver correctness (``tests/test_solver.py``): encoders, the greedy and
native packers, routing, the auction, repair, the sharded sweep and the
sampled path — run against the port, the sharded tests on eight CPU
blocks. ``"cuda"`` takes the place the reference gives ``"tpu"`` as the
accelerator's backend name (``solver/auction.py::resolve_candidates``,
``solver/routing.py::choose_path``); the port's device count and tensors
take the place of ``jax.devices()`` and ``jnp.asarray``."""

from test_torch_twins import load_twin

_MESH_IMPORTS = (
    "    from slurm_bridge_tpu_torch.parallel import solver_mesh\n"
    "    from slurm_bridge_tpu_torch.parallel.mesh import process_devices\n"
)

globals().update(load_twin(
    "test_solver",
    rewrites=[
        ('backend_name="tpu"', 'backend_name="cuda"'),
        (', "tpu", ', ', "cuda", '),
        ("    import jax\n    from slurm_bridge_tpu_torch.parallel import solver_mesh\n",
         _MESH_IMPORTS),
        ("    import jax\n\n    from slurm_bridge_tpu_torch.parallel import solver_mesh\n",
         _MESH_IMPORTS),
        ("len(jax.devices())", 'len(process_devices("cpu"))'),
        ("    import jax.numpy as jnp\n    from slurm_bridge_tpu_torch.solver.auction "
         "import segmented_cumsum\n",
         "    import torch\n    from slurm_bridge_tpu_torch.solver.auction "
         "import segmented_cumsum\n"),
        ("segmented_cumsum(jnp.asarray(vals), jnp.asarray(seg))",
         "segmented_cumsum(torch.asarray(vals), torch.asarray(seg))"),
    ],
    drop=[
        # JAX-only: it holds shard_map's jit cache (one compiled program per
        # mesh, shape and config). The port's sweep is eager and compiles
        # no program per mesh: its one compiled piece, the bid_argmax
        # library, is built once and loaded once per process
        # (ops/bid_argmax.py::_kernel), and each block's kernel call is
        # held on the card by
        # tests/test_torch_cuda.py::test_kernel_offsets_with_live_and_incumbents
        "test_sharded_kernel_cached",
    ],
    eight_devices=True,
))
