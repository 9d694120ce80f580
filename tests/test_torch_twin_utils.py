"""The support utilities' tests (``tests/test_utils.py``): the config
codec, flag validators, atomic files, the filesystem watcher, inotify, the
file tailer and the virtual-node config, run against the port's
``utils``."""

from test_torch_twins import load_twin

globals().update(load_twin(
    "test_utils",
    drop=[
        # utils/chipstate.py is not ported: it records a TPU's health for
        # the JAX package's backend probe, and its only readers are
        # bench.py's; the port's backend never probes (parallel/backend.py)
        "test_ensure_backend_short_circuits_on_dead_chip",
    ],
))
