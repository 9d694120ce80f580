"""The forked decode pool's equivalence tests (``tests/test_colpool.py``),
run against the port's pool, the per-shard mirror split of the shard
executor included."""

from test_torch_twins import load_twin

globals().update(load_twin("test_colpool"))
