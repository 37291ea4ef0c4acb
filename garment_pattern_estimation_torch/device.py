"""Device and compute-dtype resolution for the port's entry points.

Entry points run on the card: `device=None` means CUDA, and a missing CUDA
device is an error, never a silent move to the CPU. The CPU is taken only
when the caller names it (the tests do). The NN config's `compute_dtype`
names f32 (None, 'float32') or the bf16 mixed-precision mode ('bfloat16')."""
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


def resolve_compute_dtype(compute_dtype=None):
    """The mixed-precision mode's compute dtype: None for f32 (None,
    'float32' or torch.float32), torch.bfloat16 for 'bfloat16' or
    torch.bfloat16; any other value raises ValueError."""
    if compute_dtype in (None, 'float32', torch.float32):
        return None
    if compute_dtype in ('bfloat16', torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f'compute_dtype must be None, float32 or bfloat16, got {compute_dtype!r}')
