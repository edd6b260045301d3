"""Where an entry point runs: the card unless the caller names another device."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Asking for CUDA (explicitly or by default) on a machine without a CUDA
    device raises: an entry point never continues silently on the CPU.
    Pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain path on the CPU")
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
