"""Which device an entry point runs on: the card unless the caller asks
for the CPU."""
from __future__ import annotations

import torch


def check_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no GPU raises (the
    CPU runs only when asked for)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but none is "
                           "available; pass device='cpu' to run on the CPU")
    return device
