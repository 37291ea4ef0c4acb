"""The serving pipeline: raw points in physical units -> pattern tensors in
physical units.

Counterpart of garment_pattern_estimation_tpu/experiment/serving.py:41-69:
standardize the cloud with the data config's `f_shift`/`f_scale`, run the
eval forward, un-standardize the prediction keys that have ground-truth
statistics. The exported artifact of the JAX package has no counterpart
yet (ROADMAP queue A, `experiment/`).
"""
from __future__ import annotations

import torch

# prediction keys that un-standardize back to physical units; the rest
# (free-edge logits, attention weights) pass through raw
_GT_KEYS = ('outlines', 'rotations', 'translations', 'stitch_tags')


def build_serving_fn(model, data_config):
    """`serve(points (B, N, 3)) -> {key: tensor}` on the model's device.
    A missing `f_shift`/`f_scale` means identity."""
    device = model.device
    std = data_config.get('standardize', {})

    def vec(values):
        return torch.as_tensor(values, dtype=torch.float32, device=device)

    f_shift = vec(std.get('f_shift', [0.0, 0.0, 0.0]))
    f_scale = vec(std.get('f_scale', [1.0, 1.0, 1.0]))
    gt_shift = {k: vec(v) for k, v in std.get('gt_shift', {}).items() if k in _GT_KEYS}
    gt_scale = {k: vec(v) for k, v in std.get('gt_scale', {}).items() if k in _GT_KEYS}

    @torch.inference_mode()
    def serve(points):
        x = (torch.as_tensor(points, device=device).float() - f_shift) / f_scale
        preds = model.module(x.contiguous())
        return {key: value * gt_scale[key] + gt_shift[key] if key in gt_shift else value
                for key, value in preds.items()}

    return serve
