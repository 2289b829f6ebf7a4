"""Device resolution shared by every entry point of the port.

The port's entry points run on the card: ``device=None`` means ``cuda``, and
a machine without a usable CUDA device raises instead of quietly running on
the CPU. The CPU is used only when the caller asks for it by name, as the
tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda``; any CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "poisson_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions on the "
            "CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def device_name(device) -> str:
    """Human-readable device kind for reports: the card's name, or ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"
