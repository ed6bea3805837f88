"""The port's device rule: an entry point runs on the card unless the
caller names another device (device="cpu" runs every kernel wrapper's
plain PyTorch version). Without a card the default raises."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU "
                "with the kernels' plain versions")
        return torch.device("cuda")
    return torch.device(device)
