"""Streaming reschedule (``tests/test_streaming.py``): incumbents keep
their nodes, never migrate, yield to priority; churn stays feasible and
stable; the native engine's preempt-only-when-necessary semantics — run
against the port."""

from test_torch_twins import load_twin

globals().update(load_twin(
    "test_streaming",
    drop=[
        # both need the multi-device sweep (ROADMAP Queue 1 item 8), which
        # the port does not carry: its streaming_place(sharded=True) raises
        "test_sharded_handles_persistent_gang_ids",
        "test_sharded_streaming_matches_single_device",
    ],
))
