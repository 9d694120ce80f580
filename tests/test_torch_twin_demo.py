"""The quick-start demo (``tests/test_demo.py``), run as
``python -m slurm_bridge_tpu_torch.bridge.demo`` with ``SBT_BACKEND=cpu``
(the reference's file sets it for every run)."""

from test_torch_twins import load_twin

globals().update(load_twin("test_demo"))
