"""The kube API client's tests (``tests/test_kubeapi.py``): the HTTP client
against a fake API server, the CR adapter, the node/pod mirror, the lease
elector and TLS, run against the port's ``bridge.kubeapi``."""

from test_torch_twins import load_twin

globals().update(load_twin("test_kubeapi"))
