"""The forked decode pool's equivalence tests (``tests/test_colpool.py``),
run against the port's pool. The per-shard mirror split waits for the
shard executor (ROADMAP Queue 1 item 5)."""

from test_torch_twins import load_twin

globals().update(load_twin(
    "test_colpool",
    drop=[
        # ShardExecutor.mirror_groups and the sharded scenario
        "TestMirrorGroups",
        "TestMirrorDigestEquivalence",
    ],
))
