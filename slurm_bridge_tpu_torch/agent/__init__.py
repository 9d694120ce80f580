"""The login-node agent's durable side: the Slurm CLI driver and the
agent journal.

The port carries :mod:`~slurm_bridge_tpu_torch.agent.cli` (``SlurmClient``
over the real ``sbatch``/``scontrol``/``sacct``, the ``WorkloadDriver``
seam) and :mod:`~slurm_bridge_tpu_torch.agent.journal` (the crash-safe
submit ledger the simulated agent replays after an ``agent_crash``). The
WorkloadManager gRPC server and its ``yaml`` partition config come with
the transport (ROADMAP Queue 1 item 4).
"""

from slurm_bridge_tpu_torch.agent.cli import SlurmClient, SlurmError, WorkloadDriver
from slurm_bridge_tpu_torch.agent.journal import AgentJournal

__all__ = [
    "AgentJournal",
    "SlurmClient",
    "SlurmError",
    "WorkloadDriver",
]
