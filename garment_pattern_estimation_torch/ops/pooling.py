"""Masked pooling over rectangular point batches (B, N, C) and the flat
neighbour-row gather: the counterpart of garment_pattern_estimation_tpu's
`ops/pooling.py`. The mask covers ragged or graph-pooled point sets."""
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


def gather_neighbors(features, neighbor_idx):
    """(B, N, C), ids (B, M, k) -> neighbour rows (B, M, k, C), exact f32.

    A flat row gather, the batch offsets folded into the ids, as the JAX
    package's; differentiable in `features` (the backward of
    `index_select` is an `index_add_`)."""
    B, N, C = features.shape
    offsets = (torch.arange(B, device=neighbor_idx.device) * N)[:, None, None]
    rows = (neighbor_idx + offsets).reshape(-1)
    return torch.index_select(features.reshape(B * N, C), 0, rows) \
        .reshape(*neighbor_idx.shape, C)
