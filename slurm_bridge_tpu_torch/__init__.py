"""slurm_bridge_tpu_torch — the bridge's placement solve in PyTorch and CUDA.

A second package beside ``slurm_bridge_tpu`` (the JAX reference, which it
never imports). Same layout and names, PyTorch idiom inside:

- ``core``      the typed node/partition/job model the solver lowers
- ``obs``       the metrics registry the encoders count into
- ``solver``    lowering, the auction solve and its device session, the
                native host packers, routing
- ``ops``       hand-written Hopper kernels (``csrc/*.cu``) with their plain
                PyTorch versions
- ``parallel``  backend selection (``cuda`` unless the caller asks for ``cpu``)
"""

import pathlib

#: Where every library this package compiles (the native packers, the CUDA
#: kernels) is written at first use; listed in ``.gitignore``.
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
