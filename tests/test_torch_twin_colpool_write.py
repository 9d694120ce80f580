"""The pool's write-side ops (``tests/test_colpool_write.py``), run
against the port. The reference runs its scenario-level checks on the
sharded scenarios, which wait for the shard executor; their twins on a
monolithic scenario, held against the JAX package, are in
``tests/test_torch_sim.py`` (``test_pool_is_digest_neutral_*``,
``test_raising_run_reaps_both_pools``)."""

from test_torch_twins import load_twin

globals().update(load_twin(
    "test_colpool_write",
    drop=[
        "TestWriteSideDigestParity",  # sharded_smoke
        "TestHarnessTeardown",  # sharded_smoke
        "TestFlightReconciliation",  # full_500kx100k (sharded)
    ],
))
