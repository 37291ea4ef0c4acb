"""Loss components and quality metrics of the pattern-shape models, as masked
tensor ops on fixed shapes.

Counterparts of garment_pattern_estimation_tpu/losses/components.py (the
reference's nn/metrics/losses.py and metrics.py). `pattern_stitch_loss`
comes with the stitch phase (ROADMAP queue A1).

Shape conventions (padded maxima):
  outlines (B, P, L, 4); rotations (B, P, 4); translations (B, P, 3)
  num_edges (B*P,) or (B, P) int; num_panels (B,)
"""
from __future__ import annotations

import torch


def eval_pad_vector(data_stats):
    """Padding vector in standardized space: -shift / scale."""
    shift = torch.as_tensor(data_stats['shift'], dtype=torch.float32)
    scale = torch.as_tensor(data_stats['scale'], dtype=torch.float32)
    return -shift / scale


def panel_loop_loss(predicted_outlines, gt_num_edges, pad_vector):
    """Squared norm of the sum of each panel's (un-padded) edge vectors:
    closed loops sum to zero. Panels with < 3 edges contribute nothing but
    stay in the denominator."""
    panels = predicted_outlines.reshape(-1, *predicted_outlines.shape[-2:])  # (BP, L, 4)
    BP, L, _ = panels.shape
    num_edges = gt_num_edges.reshape(-1)
    in_loop = torch.arange(L, device=panels.device)[None, :] < num_edges[:, None]
    coords = panels[..., :2] - pad_vector[:2]
    loop_sum = torch.where(in_loop[..., None], coords, 0.0).sum(dim=1)      # (BP, 2)
    loop_sum = torch.where((num_edges >= 3)[:, None], loop_sum, 0.0)
    return (loop_sum ** 2).sum() / (BP * 2)


def bce_with_logits(logits, targets, mask=None):
    """Mean binary cross-entropy on logits (torch's BCEWithLogitsLoss);
    `mask` restricts the mean to the marked elements."""
    targets = targets.to(logits.dtype)
    per_elem = (torch.clamp_min(logits, 0) - logits * targets
                + torch.log1p(torch.exp(-logits.abs())))
    if mask is None:
        return per_elem.mean()
    return torch.where(mask, per_elem, 0.0).sum() / torch.clamp_min(mask.sum(), 1)


def _torch_isclose(a, b, atol, rtol=1e-5):
    return (a - b).abs() <= atol + rtol * b.abs()


def numbers_in_panels_accuracies(predicted_outlines, gt_num_edges, gt_panel_nums,
                                 pad_vector, outline_scale):
    """Panel-count and edge-count detection accuracy from raw outlines.

    Returns (panel-count accuracy, edge-count accuracy, per-pattern
    correctness mask, edge accuracy within correct patterns: nan when no
    pattern is correct)."""
    B, P, L, E = predicted_outlines.shape
    empty_template = pad_vector.expand(L, E)
    loop_threshold = torch.tensor([3.0, 3.0], device=predicted_outlines.device) \
        / torch.as_tensor(outline_scale, device=predicted_outlines.device)[:2]

    close = _torch_isclose(predicted_outlines, empty_template, atol=0.07)   # (B, P, L, E)
    pred_num_edges = (~close.all(dim=-1)).sum(dim=-1)                       # (B, P)

    loop_distance = predicted_outlines[..., :2].sum(dim=2)                  # (B, P, 2)
    loop_open = (loop_distance.abs() > loop_threshold).any(dim=-1)          # (B, P)
    pred_num_edges = pred_num_edges + loop_open.to(pred_num_edges.dtype)

    panel_exists = pred_num_edges >= 3
    pred_num_panels = panel_exists.sum(dim=1)                               # (B,)

    gt_edges = gt_num_edges.reshape(B, P)
    panel_correct = panel_exists & (pred_num_edges == gt_edges)
    correct_edges_frac = panel_correct.sum(dim=1) / torch.clamp_min(gt_panel_nums, 1)

    correct_pattern = pred_num_panels == gt_panel_nums
    num_panel_acc = correct_pattern.float().mean()
    num_edge_acc = correct_edges_frac.float().mean()
    corr_edge_acc = torch.where(correct_pattern, correct_edges_frac, 0.0).sum() \
        / correct_pattern.sum()           # nan when no pattern is correct (0/0)
    return num_panel_acc, num_edge_acc, correct_pattern, corr_edge_acc


def _panels_to_verts(panels):
    """(BP, L, 4) edge vectors -> (BP, 2L+1, 2) vertices with the curvature
    control points interleaved."""
    BP, L, _ = panels.shape
    edge_vecs = panels[..., :2]
    ends = torch.cumsum(edge_vecs, dim=1)                       # vertex after edge e
    starts = torch.cat([panels.new_zeros(BP, 1, 2), ends[:, :-1]], dim=1)
    perp = torch.stack([-edge_vecs[..., 1], edge_vecs[..., 0]], dim=-1)
    curls = starts + panels[..., 2:3] * edge_vecs + panels[..., 3:4] * perp
    interleaved = torch.stack([curls, ends], dim=2).reshape(BP, 2 * L, 2)
    return torch.cat([panels.new_zeros(BP, 1, 2), interleaved], dim=1)


def panel_verts_l2(predicted_outlines, gt_outlines, gt_num_edges,
                   outline_shift, outline_scale, correct_mask=None):
    """Mean per-vertex L2 between un-standardized decoded panels. Returns
    (mean, mean over correct-count patterns or nan)."""
    B, P, L, E = predicted_outlines.shape
    device = predicted_outlines.device
    shift = torch.as_tensor(outline_shift, device=device)
    scale = torch.as_tensor(outline_scale, device=device)

    pred = (predicted_outlines * scale + shift).reshape(-1, L, E)
    gt = (gt_outlines * scale + shift).reshape(-1, L, E)
    num_edges = gt_num_edges.reshape(-1)

    # zero the padded edges so the cumulative sums stop at the loop's end
    edge_valid = torch.arange(L, device=device)[None, :] < num_edges[:, None]
    pred = torch.where(edge_valid[..., None], pred, 0.0)
    gt = torch.where(edge_valid[..., None], gt, 0.0)
    pred_verts = _panels_to_verts(pred)
    gt_verts = _panels_to_verts(gt)

    # valid rows: the origin and 2 per valid edge
    rows_valid = torch.arange(2 * L + 1, device=device)[None, :] < (2 * num_edges + 1)[:, None]
    n_rows = torch.clamp_min(rows_valid.sum(dim=1), 1)

    def center(v):
        mean = torch.where(rows_valid[..., None], v, 0.0).sum(dim=1) / n_rows[:, None]
        return v - mean[:, None, :]

    err = ((center(gt_verts) - center(pred_verts)) ** 2).sum(dim=-1).sqrt()
    per_panel = torch.where(rows_valid, err, 0.0).sum(dim=1) / n_rows      # (BP,)

    panel_nonempty = num_edges >= 3
    mean_err = torch.where(panel_nonempty, per_panel, 0.0).sum() \
        / torch.clamp_min(panel_nonempty.sum(), 1)
    if correct_mask is None:
        return mean_err, torch.tensor(float('nan'), device=device)
    panel_corr = correct_mask.repeat_interleave(P) & panel_nonempty
    corr_err = torch.where(panel_corr, per_panel, 0.0).sum() / panel_corr.sum()
    return mean_err, corr_err           # corr is nan when no pattern is correct


def universal_l2(predicted, gt, shift, scale, correct_mask=None):
    """Mean L2 on un-standardized placement vectors, over all B*P rows
    including empty panels."""
    P = predicted.shape[1]
    device = predicted.device
    shift = torch.as_tensor(shift, device=device)
    scale = torch.as_tensor(scale, device=device)
    pred = predicted.reshape(-1, predicted.shape[-1]) * scale + shift
    gt_flat = gt.reshape(-1, gt.shape[-1]) * scale + shift
    norms = ((gt_flat - pred) ** 2).sum(dim=-1).sqrt()
    mean_norm = norms.mean()
    if correct_mask is None:
        return mean_norm, torch.tensor(float('nan'), device=device)
    mask = correct_mask.repeat_interleave(P)
    corr = torch.where(mask, norms, 0.0).sum() / torch.clamp_min(mask.sum(), 1)
    corr = torch.where(mask.sum() > 0, corr, float('nan'))
    return mean_norm, corr
