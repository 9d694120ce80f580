"""Support utilities: the CRC-framed write-ahead log and atomic files.

The port carries what durability needs — :mod:`~slurm_bridge_tpu_torch.
utils.wal` (record frames, group-commit writer, replay) and
:mod:`~slurm_bridge_tpu_torch.utils.files` (``atomic_write``,
``ensure_dir``). The config codec (which needs ``yaml``), the flag
validators, the filesystem watcher and the file tailer come with the
agent server and the bridge runtime (ROADMAP Queue 1 item 4).
"""

from slurm_bridge_tpu_torch.utils.files import atomic_write, ensure_dir
from slurm_bridge_tpu_torch.utils.wal import (
    WalWriter,
    durable_fsync,
    pack_record,
    read_wal,
)

__all__ = [
    "WalWriter",
    "atomic_write",
    "durable_fsync",
    "ensure_dir",
    "pack_record",
    "read_wal",
]
