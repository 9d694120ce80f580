"""Twins of the JAX package's own tests, run against the port.

A twin file (``tests/test_torch_<area>.py``) calls :func:`load_twin` on a
reference test file: its source is read with the package prefix rewritten
as the copies are (``slurm_bridge_tpu.`` → ``slurm_bridge_tpu_torch.``),
plus the substitutions the twin lists (``import grpc`` becomes the port's
``wire.errors``, whose ``RpcError`` and ``StatusCode`` carry grpc's
names), and executed as a module. Its tests, fixtures and helpers become
the twin file's, minus the tests it names as not applying to the port,
each with its reason. The reference file itself is never edited.
"""

from __future__ import annotations

import pathlib
import sys
import types

import pytest

TESTS = pathlib.Path(__file__).resolve().parent

#: the substitution every twin that catches RPC failures needs
GRPC_AS_PORT_ERRORS = (
    "import grpc\n", "from slurm_bridge_tpu_torch.wire import errors as grpc\n",
)

#: every twin, for the staleness check below: stem → (rewrites, dropped)
REGISTRY: dict[str, tuple[tuple, tuple]] = {}


def load_twin(stem: str, *, rewrites=(), drop=(), eight_devices: bool = False) -> dict:
    """The namespace of ``tests/<stem>.py`` run against the port, without
    the tests in ``drop``. Each rewrite must apply, and each dropped name
    must exist, so the twin fails loudly when the reference moves on.
    ``eight_devices``: the port solves on eight CPU blocks
    (:func:`_port_eight_cpu_blocks`), for a reference file whose tests ask
    for two or more devices."""
    src = (TESTS / f"{stem}.py").read_text()
    src = src.replace("slurm_bridge_tpu.", "slurm_bridge_tpu_torch.")
    for old, new in rewrites:
        assert old in src, f"{stem}: rewrite no longer applies: {old!r}"
        src = src.replace(old, new)
    mod = types.ModuleType(f"port_twin_of_{stem}")
    mod.__file__ = str(TESTS / f"{stem}.py")
    # registered first: a dataclass defined in the file looks its module
    # up in sys.modules while the class is built. A second load (the
    # registry test below) hands the name back to the first: the twin's
    # classes resolve their string annotations through it (typing's
    # get_type_hints), and must keep finding their own siblings
    prior = sys.modules.get(mod.__name__)
    sys.modules[mod.__name__] = mod
    try:
        exec(compile(src, f"<port twin of tests/{stem}.py>", "exec"), mod.__dict__)
    finally:
        if prior is not None:
            sys.modules[mod.__name__] = prior
    ns = {k: v for k, v in vars(mod).items() if not k.startswith("__")}
    for name in drop:
        assert name in ns, f"{stem}: dropped test {name!r} no longer exists"
        del ns[name]
    ns["_port_entry_points_on_the_cpu"] = _port_entry_points_on_the_cpu
    ns["_port_module_on_the_cpu"] = _port_module_on_the_cpu
    if eight_devices:
        ns["_port_eight_cpu_blocks"] = _port_eight_cpu_blocks
    REGISTRY[stem] = (tuple(rewrites), tuple(drop))
    return ns


@pytest.fixture(autouse=True)
def _port_entry_points_on_the_cpu(monkeypatch):
    """The port's entry points run on the card unless asked for the CPU;
    the reference tests call them without a device, so a twin asks
    through the environment. Two forked pool workers per run (the suite
    runs in parallel workers; a test may set its own width), and neither
    package's pool outlives the test."""
    from slurm_bridge_tpu.parallel import colpool as jax_colpool
    from slurm_bridge_tpu_torch.parallel import colpool as port_colpool

    monkeypatch.setenv("SBT_BACKEND", "cpu")
    monkeypatch.setenv("SBT_COLPOOL_WORKERS", "2")
    yield
    port_colpool.reset()
    jax_colpool.reset()


@pytest.fixture(autouse=True, scope="module")
def _port_module_on_the_cpu():
    """The same for the twin's class- and module-scoped fixtures, which
    run their scenarios before any function-scoped fixture."""
    from slurm_bridge_tpu.parallel import colpool as jax_colpool
    from slurm_bridge_tpu_torch.parallel import colpool as port_colpool

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SBT_BACKEND", "cpu")
        mp.setenv("SBT_COLPOOL_WORKERS", "2")
        yield
        port_colpool.reset()
        jax_colpool.reset()


@pytest.fixture(autouse=True, scope="module")
def _port_eight_cpu_blocks():
    """The port's process devices as eight CPU blocks, for the whole
    module: what ``tests/conftest.py``'s eight virtual XLA devices are to
    the reference, so a route that asks for two or more devices (the
    multi-device sweep) takes it in the twin as in the reference."""
    import torch

    from slurm_bridge_tpu_torch.parallel import mesh as port_mesh

    real = port_mesh.process_devices
    cpu = torch.device("cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_mesh, "process_devices",
                   lambda backend: [cpu] * 8 if backend == "cpu" else real(backend))
        yield


def _tests_in(ns: dict) -> set[str]:
    return {
        k for k, v in ns.items()
        if (k.startswith("test_") and callable(v))
        or (k.startswith("Test") and isinstance(v, type))
    }


@pytest.mark.parametrize("stem", [
    "test_core_parsers", "test_operator_sweep", "test_colpool",
    "test_colpool_write", "test_submit_bulk", "test_mirror_bulk",
    "test_coldec", "test_sim", "test_persist", "test_agent_journal",
    "test_recovery", "test_failover_process", "test_shard", "test_chaos",
    "test_preemption", "test_streaming", "test_solver_service", "test_fleet",
    "test_fleet_obs", "test_wire", "test_store_frames", "test_incremental",
    "test_explain", "test_encoder", "test_properties", "test_manifests",
    "test_admission", "test_policy", "test_colstore", "test_agent",
    "test_bridge", "test_client", "test_races", "test_resilience",
    "test_kubeapi", "test_vkhttp", "test_demo", "test_utils", "test_obs",
    "test_flight", "test_distributed", "test_solver", "test_session",
    "test_ops", "test_store_snapshots",
])
def test_twin_runs_every_reference_test_it_does_not_drop(stem):
    """Each twin file carries every test of its reference file except the
    ones it names, and names only tests that exist."""
    import importlib

    twin = importlib.import_module(stem.replace("test_", "test_torch_twin_", 1))
    rewrites, drop = REGISTRY[stem]
    ref = _tests_in(load_twin(stem, rewrites=rewrites))
    assert set(drop) <= ref
    assert _tests_in(vars(twin)) == ref - set(drop)
