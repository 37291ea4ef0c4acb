"""Device and compute-dtype resolution for the port's entry points.

Entry points run on the card: `device=None` means CUDA, and a missing CUDA
device is an error, never a silent move to the CPU. The CPU is taken only
when the caller names it (the tests do). The NN config's `compute_dtype`
names f32 (None, 'float32') or the bf16 mixed-precision mode ('bfloat16').
Under a process group each rank's card is its own (`parallel.init_from_env`)."""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def resolve_device(device=None) -> torch.device:
    """`None` -> 'cuda'; raises when the resolved device is CUDA and no CUDA
    device is present. Under a process group, `None` and 'cuda' name this
    rank's card: cuda:LOCAL_RANK (the current device where torchrun did not
    set LOCAL_RANK)."""
    device = torch.device('cuda' if device is None else device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'garment_pattern_estimation_torch: no CUDA device is available; '
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if device.type == 'cuda' and device.index is None and dist.is_available() \
            and dist.is_initialized():
        local = os.environ.get('LOCAL_RANK')
        device = torch.device('cuda', int(local) if local is not None
                              else torch.cuda.current_device())
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
