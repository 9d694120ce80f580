"""Virtual-node (kubelet) configuration object + defaults + validation.

Reference parity: the `SlurmVirtualKubeletConfiguration` API object
(apis/kubecluster.org/v1alpha1/slurm_virtual_kubelet_types.go:11-73), its
defaults (slurm_virtual_kubelet_defaults.go:31-52 — port 10250, address
0.0.0.0, pods "10000", default TLS paths), relative-path resolution helpers
(slurm_virtual_kubelet_helpers.go:22-29), and the port-range validation
(pkg/slurm-virtual-kubelet/validation/validation.go:27-36). Loaded through
the strict-then-lenient codec like the reference's configfiles loader.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from slurm_bridge_tpu_torch.utils.codec import (
    ConfigError,
    decode_yaml_config,
    resolve_relative_paths,
)

#: fields resolved against the config file's directory when relative
PATH_FIELDS = ("tls_cert_file", "tls_key_file", "static_config_path")


@dataclass(frozen=True)
class VirtualNodeConfiguration:
    """One virtual node's serving + sync knobs."""

    node_name: str = ""
    partition: str = ""
    endpoint: str = ""                  # agent endpoint (host:port or *.sock)
    address: str = "0.0.0.0"            # kubelet HTTP bind address
    port: int = 10250                   # kubelet HTTP port (logs API)
    metrics_port: int = 10255           # declared metrics port
    pods: int = 10000                   # advertised pod capacity
    sync_frequency_s: float = 60.0      # informer resync (options.go:105)
    startup_timeout_s: float = 0.0      # abort a hung boot (virtual-kubelet.go:267)
    tls_cert_file: str = "/var/lib/sbt/kubelet.crt"
    tls_key_file: str = "/var/lib/sbt/kubelet.key"
    static_config_path: str = ""
    labels: dict[str, str] = field(default_factory=dict)


def validate_vnode_config(cfg: VirtualNodeConfiguration) -> None:
    """Port-range + required-field checks (validation.go:27-36)."""
    errs = []
    for name, value in (("port", cfg.port), ("metrics_port", cfg.metrics_port)):
        if not 0 <= value <= 65535:  # 0 = disabled
            errs.append(f"{name} {value} outside 0-65535")
    if cfg.pods < 0:
        errs.append(f"pods capacity {cfg.pods} is negative")
    if cfg.sync_frequency_s <= 0:
        errs.append(f"sync_frequency_s {cfg.sync_frequency_s} must be positive")
    if errs:
        raise ConfigError("; ".join(errs))


def load_vnode_config(path: str) -> VirtualNodeConfiguration:
    """Read + decode + resolve paths + validate, the configfiles.go flow."""
    with open(path) as f:
        cfg = decode_yaml_config(f.read(), VirtualNodeConfiguration)
    cfg = resolve_relative_paths(cfg, os.path.dirname(os.path.abspath(path)), PATH_FIELDS)
    validate_vnode_config(cfg)
    return cfg
