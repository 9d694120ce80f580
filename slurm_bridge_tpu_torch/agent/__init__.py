"""The login-node agent: Slurm CLI driver + WorkloadManager gRPC server.

Reference parity: pkg/slurm-agent (CLI client slurm.go, gRPC server
api/slurm.go) and cmd/slurm-agent (main). The driver interface is pluggable
(the reference hints at this with its wlmName abstraction api/slurm.go:355):
anything implementing :class:`cli.WorkloadDriver` can back the server.

The servicer aborts with the port's ``wire.StatusCode``, so it imports on a
machine without ``grpc`` and serves in process (``wire.rpc.LocalContext``)
as well as over the transport (``wire.serve``); the partition config
imports ``yaml`` only when it parses one. :class:`AgentJournal` is the
crash-safe submit ledger behind ``--journal``.
"""

from slurm_bridge_tpu_torch.agent.cli import SlurmClient, SlurmError, WorkloadDriver
from slurm_bridge_tpu_torch.agent.server import WorkloadServicer
from slurm_bridge_tpu_torch.agent.config import load_partition_config
from slurm_bridge_tpu_torch.agent.journal import AgentJournal

__all__ = [
    "AgentJournal",
    "SlurmClient",
    "SlurmError",
    "WorkloadDriver",
    "WorkloadServicer",
    "load_partition_config",
]
