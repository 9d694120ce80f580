"""Backend selection and the solver's device grid: the ("dp", "mp") mesh
of blocks (:mod:`mesh`) and the multi-process bootstrap
(:mod:`distributed`) of the multi-device sweep."""

from slurm_bridge_tpu_torch.parallel.mesh import solver_mesh, pad_to_multiple

__all__ = ["solver_mesh", "pad_to_multiple"]
