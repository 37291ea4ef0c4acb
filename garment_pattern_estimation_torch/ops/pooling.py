"""Masked pooling over rectangular point batches (B, N, C): the counterpart
of garment_pattern_estimation_tpu's `ops/pooling.py`. The mask covers
ragged or graph-pooled point sets."""
from __future__ import annotations

import torch

_NEG_BIG = -1e30


def masked_max_pool(features, mask=None, dim=1):
    if mask is None:
        return torch.amax(features, dim=dim)
    return torch.amax(torch.where(mask[..., None], features, _NEG_BIG), dim=dim)


def masked_mean_pool(features, mask=None, dim=1):
    if mask is None:
        return torch.mean(features, dim=dim)
    mask = mask[..., None].to(features.dtype)
    total = torch.sum(features * mask, dim=dim)
    count = torch.clamp_min(torch.sum(mask, dim=dim), 1.0)
    return total / count


def masked_add_pool(features, mask=None, dim=1):
    if mask is None:
        return torch.sum(features, dim=dim)
    return torch.sum(features * mask[..., None].to(features.dtype), dim=dim)


GLOBAL_POOLS = {
    'max': masked_max_pool,
    'mean': masked_mean_pool,
    'add': masked_add_pool,
}
