"""Device selection: the one place a ``torch.device`` is made from a name.

The entry point resolves the device once and passes it down; no module
probes for a default.  Every ``device`` default of the package, in its
parameter dataclasses and stage signatures, is :data:`DEFAULT_DEVICE`, the
card: a caller that means the CPU says ``device=torch.device("cpu")``.
Asking for ``cuda`` on a machine without a card is an error, never a
silent move to the CPU.  Resolving the card does not bring CUDA up: a
process opens its CUDA context when it first puts a tensor on the card,
so a command that launches no kernel holds none.
"""
from __future__ import annotations

import torch

from .utils.errors import InvalidParam


# the device a call runs on when its caller names none
DEFAULT_DEVICE = torch.device("cuda")


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
            # the current card; until CUDA is up in this process, card 0
            dev = torch.device("cuda", torch.cuda.current_device()
                               if torch.cuda.is_initialized() else 0)
    elif dev.type != "cpu":
        raise DeviceUnavailable(f"unsupported device {name!r}")
    return dev
