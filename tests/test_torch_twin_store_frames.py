"""The partitioned store commit (``tests/test_store_frames.py``): commit
frames built by the pool workers, their merge through
``store.apply_frames``, parity with the per-object commit and the failure
paths — run against the port."""

from test_torch_twins import load_twin

globals().update(load_twin("test_store_frames"))
