"""The agent journal's tests (``tests/test_agent_journal.py``): ledger and
job records across restarts, checkpoints, compaction, torn tails, CRC
and incarnation checks, group commit, the ``SubmitLedger`` and
``WorkloadServicer`` riding the journal across agent restarts, and the
simulated agent's lossless crash reload, run against the port's
``agent.journal`` and ``agent.server``."""

from test_torch_twins import load_twin

globals().update(load_twin("test_agent_journal"))
