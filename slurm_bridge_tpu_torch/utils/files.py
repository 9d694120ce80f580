"""Atomic file helpers.

Reference parity: the VK's util/files atomic-write helpers (SURVEY.md
§2.5): write to a temp file in the destination directory, fsync, then
rename over the target so readers never observe a partial file — the same
pattern the reference uses for kubelet TLS bootstrap artifacts.

The fsync rides :func:`utils.wal.durable_fsync`, so the simulated
disk-latency seam (``benchmarks/ticksmoke.py --wal-fsync``) covers
atomic installs exactly like WAL appends.
"""

from __future__ import annotations

import os
import tempfile

from slurm_bridge_tpu_torch.utils.wal import durable_fsync


def ensure_dir(path: str, mode: int = 0o755) -> str:
    os.makedirs(path, mode=mode, exist_ok=True)
    return path


def atomic_write(
    path: str, data: bytes | str, *, mode: int = 0o644, fsync: bool = True
) -> None:
    """Write ``data`` to ``path`` atomically (tempfile + rename).

    ``fsync=False`` skips the device flush (the simulator's
    within-process durability mode — rename atomicity is kept)."""
    if isinstance(data, str):
        data = data.encode()
    d = os.path.dirname(os.path.abspath(path))
    ensure_dir(d)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=f".{os.path.basename(path)}.")
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(data)
            fh.flush()
            if fsync:
                durable_fsync(fh.fileno())
        os.chmod(tmp, mode)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
