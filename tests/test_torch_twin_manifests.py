"""Deployment-surface hygiene (``tests/test_manifests.py``): the CRD and
deployment manifests stay in sync with the port's dataclasses — run
against the port (reads ``yaml``, which the CPU host has)."""

from test_torch_twins import load_twin

globals().update(load_twin(
    "test_manifests",
    drop=[
        # reads the agent daemon's flags (``agent.main``), which is not
        # ported yet (ROADMAP Queue 1 item 4, slice 7)
        "test_install_script_flags_match_agent",
    ],
))
