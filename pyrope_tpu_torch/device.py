"""The one place a device argument is checked.

Every index and every op that creates tensors takes ``device`` from its
caller, ``"cuda"`` when the caller names none: the port runs on the card
unless asked for the CPU. Asking for CUDA on a host without a usable GPU
raises; nothing runs on the CPU instead.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` ("cpu", "cuda", "cuda:1", a torch.device) as a checked
    torch.device; a bare "cuda" resolves to the current CUDA device, so
    tensors placed there compare equal to it."""
    if device is None:
        raise ValueError("device is required (e.g. 'cpu' or 'cuda')")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but CUDA is not available"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r} (cpu or cuda)")
    return dev
