"""Deployment-surface hygiene (``tests/test_manifests.py``): the CRD and
deployment manifests stay in sync with the port's dataclasses and the
agent daemon's flags — run against the port (reads ``yaml``, which the
CPU host has)."""

from test_torch_twins import load_twin

globals().update(load_twin("test_manifests"))
