"""Where the port's entry points run: the CUDA card unless the caller asks
for another device."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> the CUDA card, which must exist; anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card by "
                               "default; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device
