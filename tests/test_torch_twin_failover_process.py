"""Two-process leader failover (``tests/test_failover_process.py``): a
standby process contends on the port's file lease, takes over after the
primary steps down and adopts the primary's virtual nodes from the
port's snapshot and WAL."""

from test_torch_twins import load_twin

globals().update(load_twin("test_failover_process"))
