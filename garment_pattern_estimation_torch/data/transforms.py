"""Per-sample transforms (numpy): dtype normalization + standardization.

Counterparts of nn/data/transforms.py — samples stay numpy end-to-end and
become torch tensors only where a batch is collated.

The port's copy of garment_pattern_estimation_tpu/data/transforms.py:1-73.
"""
from __future__ import annotations

import numpy as np


def _normalize_value(value):
    """Arrays -> float32 unless integer/bool (dtype preserved like the
    reference's SampleToTensor — nn/data/transforms.py:544-562)."""
    if value is None:
        return np.zeros(0, dtype=np.float32)
    if isinstance(value, dict):
        return {k: _normalize_value(v) for k, v in value.items()}
    if isinstance(value, str):
        return value
    arr = np.asarray(value)
    if arr.dtype in (np.int32, np.int64, np.bool_):
        return arr
    return arr.astype(np.float32)


class SampleToTensor:
    """Normalize a sample dict to numpy arrays with NN-friendly dtypes."""

    def __call__(self, sample):
        return {key: _normalize_value(value) for key, value in sample.items()}


class FeatureStandartization:
    """(features - shift) / scale. (Name kept from the reference API.)"""

    def __init__(self, shift, scale):
        self.shift = np.asarray(shift, dtype=np.float32)
        self.scale = np.asarray(scale, dtype=np.float32)

    def __call__(self, sample):
        if isinstance(sample['features'], dict):
            # on-device-sampling mode: features are raw mesh tensors; the
            # device stage standardizes the sampled points itself
            return sample
        updated = dict(sample)
        updated['features'] = (sample['features'] - self.shift) / self.scale
        return updated


class GTtandartization:
    """Standardize dict-valued ground truth: only keys present in the stats
    are shifted/scaled. (Name kept from the reference API.)"""

    def __init__(self, shift, scale):
        self.shift = {k: np.asarray(v, dtype=np.float32) for k, v in shift.items()} \
            if isinstance(shift, dict) else np.asarray(shift, dtype=np.float32)
        self.scale = {k: np.asarray(v, dtype=np.float32) for k, v in scale.items()} \
            if isinstance(scale, dict) else np.asarray(scale, dtype=np.float32)

    def __call__(self, sample):
        gt = sample['ground_truth']
        if isinstance(gt, dict):
            new_gt = dict(gt)
            for key in gt:
                if isinstance(self.shift, dict) and key in self.shift:
                    new_gt[key] = new_gt[key] - self.shift[key]
                if isinstance(self.scale, dict) and key in self.scale:
                    new_gt[key] = new_gt[key] / self.scale[key]
        else:
            new_gt = (gt - self.shift) / self.scale
        updated = dict(sample)
        updated['ground_truth'] = new_gt
        return updated
