"""The agent journal's tests (``tests/test_agent_journal.py``): ledger and
job records across restarts, checkpoints, compaction, torn tails, CRC
and incarnation checks, group commit, and the simulated agent's lossless
crash reload, run against the port's ``agent.journal``."""

from test_torch_twins import load_twin

globals().update(load_twin(
    "test_agent_journal",
    drop=[
        # SubmitLedger and WorkloadServicer live in agent/server.py, which
        # comes with the agent server
        "test_submit_ledger_rides_journal_across_restart",
        "test_submit_ledger_journal_corrupt_degrades_with_warning",
        "test_legacy_ledger_folds_into_journal",
        "test_concurrent_puts_survive_checkpoint_race",
        "test_jobsinfo_cursor_survives_agent_restart",
        "test_nodes_cursor_survives_agent_restart",
    ],
))
