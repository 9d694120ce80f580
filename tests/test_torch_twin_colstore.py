"""The columnar tables observably identical to the object store, the
submit converters included (``tests/test_colstore.py``) — run against the
port. None is dropped."""

from test_torch_twins import load_twin

globals().update(load_twin("test_colstore"))
