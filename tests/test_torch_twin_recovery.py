"""Crash recovery and leader election (``tests/test_recovery.py``): the
simulator's crash_restart and leader_failover against their fault-free
twins, the elector's virtual clock and graceful handover, and the
configurator across a failover, run against the port."""

from test_torch_twins import load_twin

globals().update(load_twin("test_recovery"))
