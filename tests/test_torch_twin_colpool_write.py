"""The pool's write-side ops (``tests/test_colpool_write.py``), run
against the port, with the reference's scenario-level checks on the
sharded scenarios. Their monolithic twins, held against the JAX
package, are in ``tests/test_torch_sim.py``
(``test_pool_is_digest_neutral_*``, ``test_raising_run_reaps_both_pools``)."""

from test_torch_twins import load_twin

globals().update(load_twin("test_colpool_write"))
