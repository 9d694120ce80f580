"""The bridge store's persistence tests (``tests/test_persist.py``): the
snapshot round trip, the WAL's incremental flush, replay, torn tails,
corrupt records, tombstones, compaction, batch envelopes, foreign
incarnations, and a ``Bridge`` restart resuming a running job over a real
agent server, run against the port's ``bridge.persist``, ``utils.wal``
and ``Bridge``."""

from test_torch_twins import load_twin

globals().update(load_twin("test_persist"))
