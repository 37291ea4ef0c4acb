"""Sparsemax (Martins & Astudillo 2016): the projection onto the probability
simplex along the last axis, with exact zeros outside the support.

Forward only, the sort-free form of garment_pattern_estimation_tpu's
`ops/sparsemax.py` for up to 64 classes (the attention head scores 23 panel
slots) and the sorted form above that. The custom backward and the
Fenchel-Young loss come with training (ROADMAP queue A)."""
from __future__ import annotations

import torch

_SORT_FREE_MAX_CLASSES = 64


def _threshold(z):
    """tau (..., 1) of sparsemax along the last axis.

    Sort-free: element i is in the support iff k_i * z_i > sum_i - 1, with
    k_i = |{j : z_j >= z_i}| and sum_i the sum of those z_j."""
    if z.shape[-1] <= _SORT_FREE_MAX_CLASSES:
        ge = (z[..., None, :] >= z[..., :, None]).to(z.dtype)      # (..., P, P)
        k_i = ge.sum(dim=-1)
        sum_i = torch.einsum('...ij,...j->...i', ge, z)
        support = k_i * z > sum_i - 1.0
        k_support = support.sum(dim=-1, keepdim=True).to(z.dtype)
        sum_support = torch.where(support, z, 0.0).sum(dim=-1, keepdim=True)
        return (sum_support - 1.0) / k_support

    z_sorted = torch.sort(z, dim=-1, descending=True).values
    k = torch.arange(1, z.shape[-1] + 1, device=z.device, dtype=z.dtype)
    z_cumsum = torch.cumsum(z_sorted, dim=-1)
    support = k * z_sorted > z_cumsum - 1.0
    k_support = support.sum(dim=-1, keepdim=True)
    cumsum_at_k = torch.gather(z_cumsum, -1, k_support - 1)
    return (cumsum_at_k - 1.0) / k_support.to(z.dtype)


def sparsemax(z):
    return torch.clamp_min(z - _threshold(z), 0.0)
