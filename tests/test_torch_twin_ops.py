"""The kernel's parity (``tests/test_ops.py``): the fused bid/argmax
against the dense score/choose reproduced in numpy, and the auction through
it — run against the port.

The reference calls its Pallas wrapper with numpy operands (uint32 feature
masks) and ``interpret=True``; here the same call reaches the port's
wrapper (:func:`port_bid_argmax`), which on CPU tensors runs the kernel's
plain version, ``bid_argmax_plain``. The CUDA kernel itself is held against
that plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

import numpy as np
import torch

import slurm_bridge_tpu_torch.ops.bid_argmax as port_ops
from test_torch_twins import load_twin

#: the kernel's operands, the leading arguments of both wrappers
N_OPERANDS = 10


def port_bid_argmax(*args, interpret, **kw):
    """The reference wrapper's call on the port's: the numpy operands
    become CPU tensors, uint32 feature masks their int32 bit patterns;
    ``interpret`` picks Pallas' interpreter and has no counterpart.
    Returns (best, choice) as the port's wrapper does."""
    ops = [np.ascontiguousarray(a) for a in args[:N_OPERANDS]]
    ops = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a) for a in ops]
    return port_ops.bid_argmax(*ops, *args[N_OPERANDS:], **kw)


globals().update(load_twin(
    "test_ops",
    rewrites=[
        ("import jax\nimport jax.numpy as jnp\n", "import torch\n"),
        ("from slurm_bridge_tpu_torch.ops.bid_argmax import bid_argmax\n",
         "from test_torch_twin_ops import port_bid_argmax as bid_argmax\n"),
        ("from tests.test_solver import _check_feasible\n",
         "from test_torch_twin_solver import _check_feasible\n"),
        ("hash_jitter(p, n, salt, jnp.float32)",
         'hash_jitter(p, n, salt, torch.float32, device="cpu")'),
        # the skip marks of two tests dropped below ask jax for its backend
        ('@pytest.mark.skipif(\n    jax.default_backend() != "cpu", '
         'reason="asserts the CPU-harness default"\n)\n', ""),
        ('@pytest.mark.skipif(\n    jax.default_backend() != "tpu", '
         'reason="needs the real chip"\n)\n', ""),
    ],
    drop=[
        # TPU-only: the skip condition and the assertion read
        # jax.default_backend(). The port's auto rule (the kernel on "cuda",
        # the plain dense path on "cpu") is
        # tests/test_torch_auction.py::test_resolve_candidates_and_kernel_auto
        "test_uses_pallas_on_tpu_backend_only",
        # TPU-only: the kernel compiled by Mosaic on the chip. The CUDA
        # kernel is held bit-exact against its plain version on the card by
        # tests/test_torch_cuda.py::test_kernel_bit_exact_with_plain
        "test_bid_argmax_compiled_on_tpu_matches_reference",
        # TPU-only: SBT_PALLAS_BP/BN pick the Mosaic tile. The CUDA kernel
        # reads no tile from the environment: its tile (TILE_ROWS rows by
        # 64-node chunks) is fixed in the source and the wrapper, and a
        # library built for another tile refuses to launch
        # (ops/bid_argmax.py::_raise_on). No port test counterpart.
        "test_pallas_tile_env_validation",
    ],
))
