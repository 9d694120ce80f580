"""slurm_bridge_tpu_torch — the slurm bridge in PyTorch and CUDA.

A second package beside ``slurm_bridge_tpu`` (the JAX reference, which it
never imports). Same layout and names, PyTorch idiom inside:

- ``core``       the typed node/partition/job model and the Slurm parsers
- ``obs``        logging, metrics, events, tracing, explain, the flight
                 recorder, profiling and the daemons' observability bootstrap
- ``solver``     lowering, the auction solve and its device session, the
                 native host packers, routing, the streaming reschedule and
                 the placement-solver sidecar
- ``ops``        hand-written Hopper kernels (``csrc/*.cu``) with their plain
                 PyTorch versions
- ``parallel``   backend selection (``cuda`` unless the caller asks for
                 ``cpu``), the forked column pool and its write ops
- ``admission``  the streaming fast-path admitter and its residual view
- ``policy``     priority classes, fair share and the placement policy
- ``bridge``     the object store, operator, virtual-node provider,
                 configurator, placement scheduler, persistence, leader
                 election, result fetcher, kube API client, kubelet HTTP
                 server and the ``Bridge`` runtime with its daemon mains
- ``shard``      the sharded tick: planner, executor, cross-shard reconcile
- ``fleet``      solver sidecar processes, their supervisor and the replica
                 membership
- ``agent``      the login-node agent: the WorkloadManager servicer, its
                 Slurm CLI driver, submit journal, partition config and
                 daemon main
- ``sim``        the simulated cluster, its scenarios and the harness
- ``utils``      the write-ahead log, atomic files, the config codec, flag
                 validators, the filesystem watcher and the file tailer
- ``wire``       the messages, their proto3 codec, the column decoder and the
                 gRPC transport (``grpc`` imported only where it is used)
"""

import pathlib

__version__ = "0.1.0"

#: Where every library this package compiles (the native packers, the CUDA
#: kernels) is written at first use; listed in ``.gitignore``.
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
