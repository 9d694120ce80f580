"""The batch placement solver, in PyTorch.

Pending jobs and the node inventory are lowered into dense matrices
(:mod:`snapshot`, :mod:`encoder`) and placed by a fixed-round auction
(:mod:`auction`) whose score/choose step is the hand-written Hopper kernel
``bid_argmax``; :mod:`session` keeps the snapshot on the card across ticks.

Solver paths:
- ``greedy``        numpy reference packer — correctness oracle
- ``greedy_native`` C++ priority-ordered packer via ctypes — the baseline
- ``indexed_native`` the indexed C++ packer — host fast path and repair
- ``auction``       the auction sweep, on the card (or the CPU when asked)
- ``session``       ``DeviceSolver``: the auction with the snapshot staged
- ``sharded``       the multi-device sweep: the auction over a ("dp", "mp")
                    grid of blocks, each scored by the kernel
- ``routing``       which engine a solve of a given shape goes to
- ``streaming``     warm-start re-solve with incumbents pinned — stability,
                    preemption and 1k/s churn (BASELINE config #5)
- ``service``       the solver as a gRPC sidecar (``PlacementSolver``),
                    dialed by the bridge through ``solver_endpoint=``
"""

from slurm_bridge_tpu_torch.solver.snapshot import (
    ClusterSnapshot,
    JobBatch,
    Placement,
    encode_cluster,
    encode_jobs,
    random_scenario,
    RESOURCE_DIMS,
)
from slurm_bridge_tpu_torch.solver.greedy import greedy_place
from slurm_bridge_tpu_torch.solver.auction import auction_place, AuctionConfig
from slurm_bridge_tpu_torch.solver.session import DeviceSolver
from slurm_bridge_tpu_torch.solver.routing import choose_path
from slurm_bridge_tpu_torch.solver.streaming import (
    StreamingSim,
    TickResult,
    churn_scenario,
    churn_step,
    streaming_place,
)

__all__ = [
    "ClusterSnapshot",
    "JobBatch",
    "Placement",
    "encode_cluster",
    "encode_jobs",
    "random_scenario",
    "RESOURCE_DIMS",
    "greedy_place",
    "auction_place",
    "AuctionConfig",
    "DeviceSolver",
    "choose_path",
    "StreamingSim",
    "TickResult",
    "churn_scenario",
    "churn_step",
    "streaming_place",
]
