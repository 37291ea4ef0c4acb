"""Reference NeuralTailor `.pth` checkpoints as port checkpoints.

The port's state-dict names are the reference's (`models/flax_import.py`),
so a reference file loads without a rename: its state dict (the file's
`model_state_dict`, or the whole file when it is a bare state dict) loses
DataParallel's `module.` prefix and becomes the `'model'` entry of a port
checkpoint dict. Optimizer and scheduler states are not carried over.

Counterpart of garment_pattern_estimation_tpu/experiment/torch_import.py:25-42
and `load_checkpoint_any` (:152-161), which turn the same files into flax
variables.
"""
from __future__ import annotations

from collections import OrderedDict
from pathlib import Path

import torch

from .checkpoint import load_checkpoint_file


def load_checkpoint_any(path, map_location='cpu'):
    """A port checkpoint (`checkpoint.save_checkpoint_file`) or a reference
    `.pth` file as a port checkpoint dict {'model': state dict, 'epoch':
    int or None}, tensors on `map_location`. Both load with
    `weights_only=True`."""
    path = Path(path)
    if path.suffix != '.pth':
        return load_checkpoint_file(path, map_location=map_location)
    if not path.exists():
        raise FileNotFoundError(path)
    ckpt = torch.load(path, map_location=map_location, weights_only=True)
    epoch = None
    if isinstance(ckpt, dict) and 'model_state_dict' in ckpt:
        epoch = ckpt.get('epoch')
        ckpt = ckpt['model_state_dict']
    state = OrderedDict((key.removeprefix('module.'), value) for key, value in ckpt.items())
    return {'model': state, 'epoch': epoch}
