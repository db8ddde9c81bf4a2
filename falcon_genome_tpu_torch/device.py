"""Device selection: the one place a ``torch.device`` is made from a name.

The entry point resolves the device once and passes it down; no module
probes for a default.  Asking for ``cuda`` on a machine without a card is
an error, never a silent move to the CPU.
"""
from __future__ import annotations

import torch

from .utils.errors import InvalidParam


class DeviceUnavailable(InvalidParam):
    """The requested device does not exist on this machine."""


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cuda"``/``"cpu"`` (or a device) → ``torch.device``; raises
    :class:`DeviceUnavailable` for ``cuda`` when no card is visible."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "--device cuda: no CUDA device is available "
                "(use --device cpu to run the plain PyTorch versions)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise DeviceUnavailable(f"unsupported device {name!r}")
    return dev
