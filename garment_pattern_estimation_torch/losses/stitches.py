"""Stitch decoding from predicted tags, host side.

`tags_to_stitches_np` is the port's copy of
garment_pattern_estimation_tpu/losses/stitches.py:22-56, the greedy decoder
on the prediction -> pattern-JSON path that the dataset uses (numpy, as
there). The in-training decoder and the stitch precision/recall metric
wait for the stitch losses.
"""
from __future__ import annotations

import numpy as np

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
