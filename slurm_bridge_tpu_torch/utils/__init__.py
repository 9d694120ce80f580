"""Support utilities: config codec, flag validators, atomic files, the
CRC-framed write-ahead log, filesystem interface + watcher, and the
line-oriented file tailer.

Reference parity: the reference's support layer (SURVEY.md §2.8) —
pkg/common/flag, pkg/filesystem, pkg/tail, and the VK's config plumbing
(codec / configfiles / util/files, SURVEY.md §2.5). The codec imports
``yaml`` only when it decodes or encodes, so this package imports on a
machine without it.
"""

from slurm_bridge_tpu_torch.utils.codec import (
    ConfigError,
    decode_yaml_config,
    encode_yaml_config,
    explicit_flags,
    resolve_relative_paths,
)
from slurm_bridge_tpu_torch.utils.files import atomic_write, ensure_dir
from slurm_bridge_tpu_torch.utils.flags import ip_address, ip_port, port_range
from slurm_bridge_tpu_torch.utils.fs import DefaultFs, FsWatcher
from slurm_bridge_tpu_torch.utils.tail import LeakyBucket, Tail, TailConfig
from slurm_bridge_tpu_torch.utils.wal import (
    WalWriter,
    durable_fsync,
    pack_record,
    read_wal,
)

__all__ = [
    "ConfigError",
    "decode_yaml_config",
    "encode_yaml_config",
    "explicit_flags",
    "resolve_relative_paths",
    "atomic_write",
    "ensure_dir",
    "ip_address",
    "ip_port",
    "port_range",
    "DefaultFs",
    "FsWatcher",
    "Tail",
    "TailConfig",
    "LeakyBucket",
    "WalWriter",
    "durable_fsync",
    "pack_record",
    "read_wal",
]
