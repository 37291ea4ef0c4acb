"""Stitch decoding from predicted tags, and the stitch precision/recall
metric.

`tags_to_stitches_np` is the port's copy of
garment_pattern_estimation_tpu/losses/stitches.py:22-56, the greedy decoder
on the prediction -> pattern-JSON path that the dataset uses (numpy, as
there). `tags_to_stitches_jit` (:59-97 there, the same name) is the same
algorithm as fixed-shape masked tensor ops for the in-training quality
metric `stitch_precision_recall` (:100-139): batched over the patterns, on
the tensors' device, with no host synchronization in its loop.
"""
from __future__ import annotations

import numpy as np
import torch

_INF = np.inf


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def tags_to_stitches_np(stitch_tags, free_edges_score):
    """Greedy min-distance pairing of non-free edge tags.

    stitch_tags (P, L, 3) or (E, 3); free_edges_score (P, L) or (E,) logits.
    Returns (2, n_stitches) int array of pattern-level edge ids (may be empty).
    """
    flat_tags = np.asarray(stitch_tags).reshape(-1, np.asarray(stitch_tags).shape[-1])
    flat_scores = np.asarray(free_edges_score).reshape(-1)
    free_mask = np.round(_sigmoid(flat_scores)).astype(bool)

    non_free_mask = ~free_mask
    non_free_edges = np.flatnonzero(non_free_mask)
    if non_free_mask.sum() == 0 or len(non_free_edges) < 2:
        print('tags_to_stitches::Warning::no non-zero stitch tags detected')
        return np.zeros((2, 0), dtype=np.int64)

    if len(non_free_edges) % 2:  # odd count: drop the most-free-looking edge
        to_remove = flat_scores[non_free_mask].argmax()
        non_free_mask[non_free_edges[to_remove]] = False
        non_free_edges = np.flatnonzero(non_free_mask)

    num = len(non_free_edges)
    tags = flat_tags[non_free_mask]
    dist = np.sqrt(((tags[:, None, :] - tags[None, :, :]) ** 2).sum(-1))
    tril = np.tril_indices(num)
    dist[tril] = _INF

    stitches = []
    for _ in range(num // 2):
        flat_min = dist.argmin()
        row, col = flat_min // num, flat_min % num
        stitches.append([int(non_free_edges[row]), int(non_free_edges[col])])
        dist[row, :] = dist[:, row] = dist[:, col] = dist[col, :] = _INF

    return np.array(stitches, dtype=np.int64).T if stitches else np.zeros((2, 0), dtype=np.int64)


def tags_to_stitches_jit(stitch_tags, free_edges_score, max_stitches):
    """The greedy decoder on fixed shapes, one pattern per leading index:
    stitch_tags (B, P, L, T) or (B, E, T), free_edges_score (B, P, L) or
    (B, E) logits. Returns (pairs (B, max_stitches, 2) int64 edge ids,
    valid (B, max_stitches) bool); the valid pairs come first, in the order
    they were found, and the rest are zeros. Decoding stops at
    `max_stitches` pairs.

    Each of the `max_stitches` steps takes the first minimum of the
    remaining (row < column) distances of every pattern at once, as one
    (B, E, E) tensor; a pattern with no finite distance left keeps its
    tensor and records an invalid pair."""
    B = stitch_tags.shape[0]
    flat_tags = stitch_tags.reshape(B, -1, stitch_tags.shape[-1])
    E = flat_tags.shape[1]
    flat_scores = free_edges_score.reshape(B, E)
    device = flat_tags.device
    edge_ids = torch.arange(E, device=device)

    non_free = ~(torch.round(torch.sigmoid(flat_scores)) > 0.5)
    # odd count: the non-free edge with the highest free score becomes free
    drop_idx = torch.where(non_free, flat_scores, float('-inf')).argmax(dim=1)
    odd = non_free.sum(dim=1) % 2 == 1
    non_free = non_free & ~(odd[:, None] & (edge_ids[None, :] == drop_idx[:, None]))

    upper = edge_ids[:, None] < edge_ids[None, :]
    dist = ((flat_tags[:, :, None] - flat_tags[:, None, :]) ** 2).sum(dim=-1).sqrt()
    dist = torch.where(non_free[:, :, None] & non_free[:, None, :] & upper, dist,
                       float('inf'))

    rows, cols, valid = [], [], []
    for _ in range(max_stitches):
        flat = dist.reshape(B, E * E)
        flat_min = flat.argmin(dim=1)                       # the first minimum
        is_valid = torch.isfinite(flat.gather(1, flat_min[:, None])[:, 0])
        row, col = flat_min // E, flat_min % E
        rows.append(torch.where(is_valid, row, 0))
        cols.append(torch.where(is_valid, col, 0))
        valid.append(is_valid)
        kill = (edge_ids[None, :] == row[:, None]) | (edge_ids[None, :] == col[:, None])
        dist = torch.where(is_valid[:, None, None] & (kill[:, :, None] | kill[:, None, :]),
                           float('inf'), dist)
    return torch.stack([torch.stack(rows, 1), torch.stack(cols, 1)], dim=-1), \
        torch.stack(valid, 1)


def stitch_precision_recall(stitch_tags, free_edges_score, gt_stitches,
                            gt_stitches_nums, max_stitches, correct_mask=None):
    """Batch-mean precision and recall of the decoded stitches against the
    GT pairs, each stitch order-invariant. Returns (precision, recall,
    corr_precision, corr_recall): the corr_* over the patterns of
    `correct_mask` that decoded a stitch, NaN where none qualifies or no
    mask is given."""
    B = stitch_tags.shape[0]
    pairs, valid = tags_to_stitches_jit(stitch_tags, free_edges_score, max_stitches)
    n_detected = valid.sum(dim=1)

    S = gt_stitches.shape[-1]
    gt = gt_stitches.long()
    gt_valid = torch.arange(S, device=gt.device)[None, :] < gt_stitches_nums[:, None]
    d0, d1 = pairs[..., 0, None], pairs[..., 1, None]           # (B, M, 1)
    g0, g1 = gt[:, None, 0], gt[:, None, 1]                     # (B, 1, S)
    match = ((d0 == g0) & (d1 == g1)) | ((d0 == g1) & (d1 == g0))
    match = match & gt_valid[:, None, :] & valid[:, :, None]
    n_correct = match.any(dim=2).sum(dim=1)

    precision = torch.where(n_detected > 0, n_correct / torch.clamp_min(n_detected, 1), 0.0)
    recall = torch.where(gt_stitches_nums > 0,
                         n_correct / torch.clamp_min(gt_stitches_nums, 1), 0.0)
    tot_precision, tot_recall = precision.sum() / B, recall.sum() / B
    if correct_mask is None:
        nan = torch.tensor(float('nan'), device=precision.device)
        return tot_precision, tot_recall, nan, nan
    qualify = correct_mask & (n_detected > 0)
    n_q = qualify.sum()

    def corr(values):
        mean = torch.where(qualify, values, 0.0).sum() / torch.clamp_min(n_q, 1)
        return torch.where(n_q > 0, mean, float('nan'))
    return tot_precision, tot_recall, corr(precision), corr(recall)
