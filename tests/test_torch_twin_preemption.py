"""Preemption in the placement scheduler (``tests/test_preemption.py``):
placement hints reaching ``sbatch``, priority preemption through a live
``Bridge`` over the fake Slurm CLI, the cancel retry after a failed
preemption, across an agent crash with the agent journal, run against the
port; RPC failures are the port's ``RpcError``."""

from test_torch_twins import GRPC_AS_PORT_ERRORS, load_twin

globals().update(load_twin("test_preemption", rewrites=[GRPC_AS_PORT_ERRORS]))
