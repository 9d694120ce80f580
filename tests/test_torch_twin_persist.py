"""The bridge store's persistence tests (``tests/test_persist.py``): the
snapshot round trip, the WAL's incremental flush, replay, torn tails,
corrupt records, tombstones, compaction, batch envelopes and foreign
incarnations, run against the port's ``bridge.persist`` and
``utils.wal``."""

from test_torch_twins import load_twin

globals().update(load_twin(
    "test_persist",
    rewrites=[
        # the agent server, the Bridge runtime and the gRPC transport come
        # with the transport slice; only the end-to-end restart uses them
        ("from slurm_bridge_tpu_torch.agent import SlurmClient, WorkloadServicer\n", ""),
        ("from slurm_bridge_tpu_torch.bridge import Bridge, BridgeJobSpec, JobState\n",
         "from slurm_bridge_tpu_torch.bridge import BridgeJobSpec, JobState\n"),
        ("from slurm_bridge_tpu_torch.wire import serve\n", ""),
    ],
    drop=[
        # a real agent server and Bridge over the fake Slurm CLI
        "test_restart_resume_running_job",
    ],
))
