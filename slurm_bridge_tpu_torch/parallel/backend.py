"""Backend selection for the solver's entry points: the card, or the CPU
when asked.

The JAX package probes its accelerator in a subprocess and degrades to the
CPU when the probe fails or hangs. The port does not: a solve that should
run on the card and silently runs on the host instead hides exactly what a
deployment pays for. So :func:`ensure_backend` returns

- ``"cuda"`` when ``torch.cuda.is_available()``,
- ``"cpu"`` only when the caller passes ``device="cpu"`` or the operator
  sets ``SBT_BACKEND=cpu``,

and raises :class:`BackendUnavailable` in every other case.
"""

from __future__ import annotations

import os

import torch


class BackendUnavailable(RuntimeError):
    """The card was asked for (explicitly or by default) and is absent."""


def ensure_backend(device: str | torch.device | None = None) -> str:
    """Return the torch backend a solve runs on: ``"cuda"`` or ``"cpu"``.

    ``device`` is the caller's explicit choice; ``None`` means the card,
    unless ``SBT_BACKEND=cpu`` pins the CPU.
    """
    if device is None:
        forced = os.environ.get("SBT_BACKEND", "").lower()
        if forced not in ("", "cpu", "cuda"):
            raise ValueError(f"SBT_BACKEND={forced!r}: want cpu|cuda")
        name = forced or "cuda"
    else:
        name = torch.device(device).type
    if name == "cpu":
        return "cpu"
    if name != "cuda":
        raise ValueError(f"unsupported device {device!r}: want cuda|cpu")
    if not torch.cuda.is_available():
        raise BackendUnavailable(
            "no CUDA device is available; pass device='cpu' or set "
            "SBT_BACKEND=cpu to solve on the host"
        )
    return "cuda"
