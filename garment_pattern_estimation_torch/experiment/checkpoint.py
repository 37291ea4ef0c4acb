"""Checkpoint files of the port: `torch.save` of a plain dict, e.g.::

    {'epoch': int, 'step': int, 'model': module.state_dict(),
     'optimizer': optimizer.state_dict()}

holding tensors and plain Python types only, so `torch.load(...,
weights_only=True)` reads it back without unpickling arbitrary objects.

Counterpart of garment_pattern_estimation_tpu/experiment/checkpoint.py (msgpack
pytrees there); the two formats are not interchangeable. Weights cross from
the JAX package through `models.flax_import.state_dict_from_flax`.
"""
from __future__ import annotations

import os
from pathlib import Path

import torch


def save_checkpoint_file(state, path):
    """Write `state` to `path` through a temporary file and an atomic rename,
    so a crash never leaves a torn checkpoint."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + '.tmp')
    torch.save(state, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint_file(path, map_location='cpu'):
    """The dict `save_checkpoint_file` wrote, tensors on `map_location`."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(path)
    return torch.load(path, map_location=map_location, weights_only=True)
