"""Store semantics (``tests/test_store_snapshots.py``): frozen copy-on-read
snapshots, the (kind, node_name) index, the per-kind dirty set, batched
optimistic writes and the transitive owner cascade — run against the
port's ``bridge/{freeze,objects,store}.py``."""

from test_torch_twins import load_twin

globals().update(load_twin("test_store_snapshots"))
