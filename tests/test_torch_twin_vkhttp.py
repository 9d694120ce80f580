"""The kubelet HTTP server's tests (``tests/test_vkhttp.py``): container
logs and exec over HTTP(S) from a live ``Bridge``, run against the port's
``bridge.vkhttp``."""

from test_torch_twins import load_twin

globals().update(load_twin("test_vkhttp"))
