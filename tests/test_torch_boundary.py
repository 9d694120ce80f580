"""The port imports nothing of JAX and nothing of the JAX package."""

import pathlib
import subprocess
import sys

import slurm_bridge_tpu_torch

_PKG = pathlib.Path(slurm_bridge_tpu_torch.__file__).resolve().parent


def _port_modules():
    names = []
    for path in sorted(_PKG.rglob("*.py")):
        rel = path.relative_to(_PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        names.append(".".join(parts))
    return names


def test_port_modules_import_no_jax():
    mods = _port_modules()
    assert "slurm_bridge_tpu_torch.solver.auction" in mods
    assert "slurm_bridge_tpu_torch.ops.bid_argmax" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'slurm_bridge_tpu' or k.startswith('slurm_bridge_tpu.')]\n"
        "print(json.dumps(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=_PKG.parent, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py reaches only the port (checked on its source, since
    running it needs the card)."""
    src = (_PKG.parent / "chip_smoke.py").read_text()
    for line in src.splitlines():
        stripped = line.strip()
        if stripped.startswith(("import ", "from ")):
            mod = stripped.split()[1]
            assert mod != "jax" and not mod.startswith("jax.")
            assert mod != "slurm_bridge_tpu" and not mod.startswith("slurm_bridge_tpu.")
