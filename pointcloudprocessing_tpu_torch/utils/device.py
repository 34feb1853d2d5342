"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def require_device(device: torch.device | str) -> torch.device:
    """The device a model entry point builds on: ``device`` itself, and a
    clear error, not a silent CPU build, when it is CUDA and CUDA is
    absent. Callers that mean the CPU say ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for (the default of the model "
            "entry points), but CUDA is not available; pass device='cpu' to "
            "build on the CPU"
        )
    return device
