"""Device resolution shared by every entry point of the port.

The port is built for the card: an entry point given no device runs on
``cuda`` and raises when CUDA is absent, instead of quietly running on
the CPU.  Callers that want the CPU (the parity tests) say so with
``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda``; raises if the resolved device is CUDA and no
    card is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' to run its plain PyTorch path on the CPU")
    return dev
