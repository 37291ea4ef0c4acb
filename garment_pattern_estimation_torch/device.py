"""Device resolution for the port's entry points.

Entry points run on the card: `device=None` means CUDA, and a missing CUDA
device is an error, never a silent move to the CPU. The CPU is taken only
when the caller names it (the tests do)."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> 'cuda'; raises when the resolved device is CUDA and no CUDA
    device is present."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'garment_pattern_estimation_torch: no CUDA device is available; '
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return device
