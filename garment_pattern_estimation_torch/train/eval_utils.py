"""Model evaluation shortcuts: a batch predict function and the mean of
every loss and quality metric over a data section.

Counterpart of garment_pattern_estimation_tpu/train/eval_utils.py. The
stitch model's exhaustive pairs (every cross-panel edge pair of a pattern,
a different count per pattern) are padded to a power-of-two bucket and
masked, as the JAX package pads them to bound its compilations: the same
shapes, so the two compute the same means. Mesh-dict features
(`dataset.on_device_sampling`) are sampled on the model's device first
(preprocess/device_sampling.py); the snap of their labels runs only where
the loss reads them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import InvalidPatternDefError
from ..preprocess.device_sampling import (SAMPLING_STREAM, maybe_batch_sampler,
                                          reads_segmentation)


def _bucket_size(n):
    """Next power of two, at least 32: the bucket of a pair count."""
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 5)


def _generator(device, rng_seed, counter):
    """The generator of call (or batch) `counter`: the counterpart of JAX's
    fold_in(PRNGKey(rng_seed), counter). Its draws differ from JAX's; their
    law is the same."""
    seed = (int(rng_seed) * 1_000_003 + counter) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(seed)


def _on_device(features, device):
    """A mesh-dict batch's tensors on `device`."""
    return {k: torch.as_tensor(v).to(device) for k, v in features.items()}


def make_predict_fn(model, state=None, rng_seed=0, bucket_pairs=False, device_sampler=None):
    """features (numpy or tensor batch) -> predictions as numpy (a dict for
    the shape models, an array of logits for the stitch model): an eval-mode
    forward under `torch.no_grad` on the model's device. `state`: a state
    dict loaded into the module first (None keeps its weights).

    Each call draws the LSTM decoders' initial states from a generator
    seeded from `rng_seed` and the call's count, as the JAX predict
    function folds the count into its key (serving passes none and gets
    zeros). `bucket_pairs`: a 2-D (n_pairs, F) input is padded with zero
    rows to `_bucket_size(n_pairs)` and the output cut back to n_pairs.

    `device_sampler` (preprocess/device_sampling.make_batch_sampler): mesh
    dict features are sampled on the model's device ahead of the forward,
    from the call's own sampling stream, without the label snap: the
    mesh -> prediction path."""
    if state is not None:
        model.module.load_state_dict(state)
    device = model.device
    counter = [0]

    @torch.no_grad()
    def predict(features):
        counter[0] += 1
        model.module.eval()
        if isinstance(features, dict):
            if device_sampler is None:
                raise ValueError('make_predict_fn: mesh features need a device_sampler '
                                 '(preprocess.device_sampling.make_batch_sampler)')
            features, _ = device_sampler(
                _generator(device, rng_seed, SAMPLING_STREAM + counter[0]),
                _on_device(features, device), labels=False)
        features = torch.as_tensor(features, dtype=torch.float32)
        real = features.shape[0]
        if bucket_pairs and features.dim() == 2:
            bucket = _bucket_size(real)
            if bucket != real:
                features = torch.cat([features, features.new_zeros(
                    (bucket - real,) + tuple(features.shape[1:]))])
        preds = model.module(features.to(device),
                             generator=_generator(device, rng_seed, counter[0]))
        if isinstance(preds, dict):
            return {k: v[:real].cpu().numpy() for k, v in preds.items()}
        return preds[:real].cpu().numpy()

    return predict


def eval_metrics(model, state, data_wrapper, section='test', rng_seed=0,
                 device_sampler=None):
    """Mean of every loss and quality scalar over a data section (or, for a
    per-folder section, a dict of them by folder), from the module with
    `state` loaded (None keeps its weights). NaN metrics are skipped batch
    by batch, as the reference skips None-valued ones
    (nn/metrics/eval_utils.py:12-76). Mesh-dict batches are sampled by
    `device_sampler`, by default the dataset config's
    (`maybe_batch_sampler`), with the labels in the ground truth where the
    loss reads them."""
    if device_sampler is None:
        device_sampler = maybe_batch_sampler(data_wrapper.dataset.config)
    if state is not None:
        model.module.load_state_dict(state)
    if hasattr(model.loss, 'with_quality_eval'):
        model.loss.with_quality_eval = True
    loader = data_wrapper.get_loader(section)
    if isinstance(loader, dict):
        return {folder: _eval_metrics_per_loader(model, sub_loader, rng_seed, device_sampler)
                for folder, sub_loader in loader.items()}
    return _eval_metrics_per_loader(model, loader, rng_seed, device_sampler)


def _bucket_pad(features, gt):
    """Pad a pair batch (B, n_pairs, F) with its (B, n_pairs) ground truth
    to the next bucket along the pairs. Returns (features, gt, mask), numpy;
    the mask marks the real pairs."""
    n = features.shape[1]
    bucket = _bucket_size(n)
    if bucket == n:
        return features, gt, np.ones(gt.shape, bool)
    pad = bucket - n
    features = np.concatenate(
        [features, np.zeros((features.shape[0], pad) + features.shape[2:],
                            features.dtype)], axis=1)
    mask = np.concatenate([np.ones(gt.shape, bool),
                           np.zeros(gt.shape[:1] + (pad,), bool)], axis=1)
    gt = np.concatenate([gt, np.zeros((gt.shape[0], pad), gt.dtype)], axis=1)
    return features, gt, mask


@torch.no_grad()
def _eval_metrics_per_loader(model, loader, rng_seed=0, device_sampler=None):
    device = model.device
    model.module.eval()
    current_metrics = {'full_loss': []}
    loader_iter = iter(loader)
    batch_idx = 0
    while True:
        try:
            batch = next(loader_iter)
        except StopIteration:
            break
        except InvalidPatternDefError as e:
            print(e)
            continue
        batch_idx += 1
        generator = _generator(device, rng_seed, batch_idx)
        gt = batch['ground_truth']
        if not isinstance(gt, dict) and (gt is None or np.asarray(gt).size == 0):
            gt = batch['features']  # reconstruction fallback

        features = batch['features']
        mask = None
        if isinstance(features, dict):
            labels = reads_segmentation(model.loss)
            features, segm = device_sampler(
                _generator(device, rng_seed, SAMPLING_STREAM + batch_idx),
                _on_device(features, device), labels=labels)
            if labels:
                gt = dict(gt, segmentation=segm)
        else:
            features = np.asarray(features, dtype=np.float32)
        if not isinstance(gt, dict) and features.ndim == 3 and np.asarray(gt).ndim == 2:
            # stitch pairs: variable pair counts -> bucketed + masked
            features, gt, mask = _bucket_pad(features, np.asarray(gt))
            mask = torch.from_numpy(mask).to(device)
        if isinstance(gt, dict):
            gt = {k: torch.as_tensor(v).to(device) for k, v in gt.items()}
        else:
            gt = torch.as_tensor(np.asarray(gt)).to(device)
        preds = model.module(torch.as_tensor(features).to(device), generator=generator)
        if mask is None:
            full_loss, loss_dict, _ = model.loss(preds, gt)
        else:
            full_loss, loss_dict, _ = model.loss(preds, gt, mask=mask)

        scalars = {k: v for k, v in loss_dict.items()
                   if isinstance(v, torch.Tensor) and v.dim() == 0}
        # one transfer for the batch's scalars
        fetched = torch.stack([full_loss.float()] + [v.float() for v in scalars.values()]) \
            .cpu().numpy()
        current_metrics['full_loss'].append(float(fetched[0]))
        for key, value in zip(scalars, fetched[1:]):
            if np.isnan(value):
                continue  # the reference skips None-valued metrics
            current_metrics.setdefault(key, []).append(float(value))

    return {metric: (sum(vals) / len(vals) if vals else None)
            for metric, vals in current_metrics.items()}
