"""Streaming reschedule (``tests/test_streaming.py``): incumbents keep
their nodes, never migrate, yield to priority; churn stays feasible and
stable, on one device and on the multi-device sweep; the native engine's
preempt-only-when-necessary semantics — run against the port."""

from test_torch_twins import load_twin

globals().update(load_twin("test_streaming", eight_devices=True))
