"""The typed client's tests (``tests/test_client.py``): ``Informer``,
``InformerFactory`` and ``TypedClient`` over the port's ``ObjectStore``."""

from test_torch_twins import load_twin

globals().update(load_twin("test_client"))
