"""The streaming admission plane (``tests/test_admission.py``): the
fuzzed fast-path ≡ guarded-backfill oracle, the guard and rollback
directed cases, the residual view ≡ recomputed free_after oracle, the
eligibility table, the end-to-end ``PlacementScheduler.admit`` cases, the
admission-off fixture and the interactive-storm scenario — run against
the port. None is dropped."""

from test_torch_twins import load_twin

globals().update(load_twin("test_admission"))
