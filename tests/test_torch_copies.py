"""Copy-drift gate: the port's copies of the JAX package's NumPy, ctypes
and C++ modules stay the reference text, with the import prefix rewritten
and only the changes listed here."""

import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]

#: port file (relative to both packages) → the (reference text, port text)
#: replacements the port makes after the import prefix is rewritten
ALLOWED = {
    "core/arrays.py": [],
    "solver/encoder.py": [],
    "solver/native/greedy.cpp": [],
    "solver/native/indexed.cpp": [],
    "solver/snapshot.py": [
        ("a single jitted sweep", "a single batched sweep"),
        ("(TPU-first)", "(accelerator-first)"),
    ],
    "solver/greedy.py": [
        ("baseline the JAX solver's ≥10× target is measured against",
         "baseline the device auction is measured against"),
    ],
    "solver/nativelib.py": [
        ("with g++ -O3 and cached next to their source; a rebuild happens whenever\n"
         "the source is newer than the binary. One loader serves both so build\n"
         "flags, rebuild logic, and error surfacing cannot drift apart.",
         "with g++ -O3 into the package's build directory (:data:`BUILD_DIR`, never\n"
         "next to the sources); a rebuild happens whenever the source is newer than\n"
         "the binary. One loader serves both so build flags, rebuild logic, and\n"
         "error surfacing cannot drift apart."),
        ("import threading\n", "import threading\n\nfrom slurm_bridge_tpu_torch import BUILD_DIR\n"),
        ("    import time\n\n", "    import time\n\n    lib.parent.mkdir(parents=True, exist_ok=True)\n"),
    ],
    "solver/greedy_native.py": [
        ("from slurm_bridge_tpu_torch.solver.nativelib import (",
         "from slurm_bridge_tpu_torch import BUILD_DIR\n"
         "from slurm_bridge_tpu_torch.solver.nativelib import ("),
        ('pathlib.Path(__file__).parent / "native" / "libsbtgreedy.so"',
         'BUILD_DIR / "libsbtgreedy.so"'),
    ],
    "solver/indexed_native.py": [
        ("from slurm_bridge_tpu_torch.solver.nativelib import (",
         "from slurm_bridge_tpu_torch import BUILD_DIR\n"
         "from slurm_bridge_tpu_torch.solver.nativelib import ("),
        ('pathlib.Path(__file__).parent / "native" / "libsbtindexed.so"',
         'BUILD_DIR / "libsbtindexed.so"'),
    ],
}


@pytest.mark.parametrize("rel", sorted(ALLOWED))
def test_copy_matches_reference(rel):
    ref = (ROOT / "slurm_bridge_tpu" / rel).read_text()
    want = ref.replace("slurm_bridge_tpu.", "slurm_bridge_tpu_torch.")
    for old, new in ALLOWED[rel]:
        assert want.count(old) == 1, f"{rel}: allowed change no longer applies: {old!r}"
        want = want.replace(old, new)
    assert (ROOT / "slurm_bridge_tpu_torch" / rel).read_text() == want
