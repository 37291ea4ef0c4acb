"""Pure-torch replica of the reference NeuralTailor models and their
training recipe: the reference side of the parity CLI's replica modes
(cli/parity_check.py `--torch_cross_check`, `--torch_train_cross_check`,
`--stitch_train_cross_check`).

The port's own copy of garment_pattern_estimation_tpu/experiment/
torch_reference.py, whose arithmetic it keeps line for line: the same
modules in the same construction order (so `torch.manual_seed(s)` draws the
same weights in both), the same forwards, the same recipe losses and the
same training loops, bitwise equal on the CPU (tests/test_torch_parity_
train.py). What differs: every tensor the loops and losses make (batches,
the pad vector, the LSTM initial states, index ranges) is made on the
model's device, so the replica trains and evaluates on the card as well
as on the CPU.

It is an independent re-implementation of the architecture described by
the reference (nn/nets.py:41-299, nn/net_blocks.py:93-191,363-402):
dynamic EdgeConv encoder (kNN from current features, edge MLP on
[x_i ; x_j - x_i], max aggregation), sparsemax point->panel attention, LSTM
sequence decoders, linear placement head; zero initial recurrent states.
Its kNN ranks with `cdist` + `topk`, not with the port's kernels: it is the
reference recipe, held beside the port, and nothing on the port's serving
or training path imports this module. The port's kernels stay held to the
JAX package's (tests/test_torch_*.py).

The state-dict names are the reference's, and so the port's
(`models/flax_import.py`): one init loads into the replica and into the
port's model without a name map, apart from the attention model's unused
global-pool `feature_extractor.lin`, which only the replica has.
"""
from __future__ import annotations

import copy

import numpy as np
import torch
import torch.nn as nn


def _mlp(sizes):
    """Reference MLP naming: Sequential of Sequential(Linear, ReLU, BN1d) —
    state-dict keys `<p>.{i}.0.*` / `<p>.{i}.2.*`."""
    layers = []
    for cin, cout in zip(sizes[:-1], sizes[1:]):
        layers.append(nn.Sequential(nn.Linear(cin, cout), nn.ReLU(),
                                    nn.BatchNorm1d(cout)))
    return nn.Sequential(*layers)


def _device_of(model):
    return next(model.parameters()).device


def sparsemax_torch(logits):
    """Closed-form sparsemax (projection onto the simplex) over the last axis."""
    z, _ = torch.sort(logits, dim=-1, descending=True)
    cumsum = torch.cumsum(z, dim=-1)
    k = torch.arange(1, logits.shape[-1] + 1, dtype=logits.dtype,
                     device=logits.device)
    support = 1.0 + k * z > cumsum
    k_z = support.sum(dim=-1, keepdim=True).clamp(min=1)
    tau = (torch.gather(cumsum, -1, k_z - 1) - 1.0) / k_z.to(logits.dtype)
    return torch.clamp(logits - tau, min=0.0)


class _DynamicEdgeConv(nn.Module):
    """kNN graph rebuilt from current features each call (`cdist` + `topk`);
    edge MLP + max. The neighbours are gathered from an expanded (B, N, N,
    C) view, whose gradient the backward materializes: 4 B N^2 C bytes, 72
    GB for conv1 of a (30, 2000) att batch at C = 150."""

    def __init__(self, mlp, k):
        super().__init__()
        self.nn = mlp          # attribute name 'nn' -> keys `...nn.{i}...`
        self.k = k

    def forward(self, x):                      # (B, N, C)
        B, N, C = x.shape
        d = torch.cdist(x, x) ** 2
        idx = torch.topk(d, min(self.k, N), dim=-1, largest=False).indices
        nbr = torch.gather(
            x.unsqueeze(1).expand(B, N, N, C), 2,
            idx.unsqueeze(-1).expand(B, N, idx.shape[-1], C))
        center = x.unsqueeze(2).expand_as(nbr)
        edge = torch.cat([center, nbr - center], dim=-1)
        out = self.nn(edge.reshape(-1, 2 * C)).reshape(B, N, idx.shape[-1], -1)
        return out.max(dim=2).values


class _EdgeConvFeatures(nn.Module):
    """Reference EdgeConvFeatures: stacked dynamic EdgeConv + optional xyz
    skip + mean pool + linear head (keys feature_extractor.conv_layers.{i}.nn,
    feature_extractor.lin)."""

    def __init__(self, out_size, conv_depth=2, k=5, hidden=200,
                 hidden_depth=2, feature=150, skip_connections=True):
        super().__init__()
        self.skip_connections = skip_connections
        convs = []
        in_size = 3
        for _ in range(conv_depth):
            convs.append(_DynamicEdgeConv(
                _mlp([2 * in_size] + [hidden] * hidden_depth + [feature]), k))
            in_size = feature
        self.conv_layers = nn.ModuleList(convs)
        self.lin = nn.Linear(feature + (3 if skip_connections else 0), out_size)

    def forward(self, positions, pool_global=True):
        out = positions
        for conv in self.conv_layers:
            out = conv(out)
        if self.skip_connections:
            out = torch.cat([out, positions], dim=-1)
        if pool_global:
            return self.lin(out.mean(dim=1)), out
        return None, out


class _LSTMDecoder(nn.Module):
    """Reference LSTMDecoderModule: encoding repeated out_len times as LSTM
    input, linear head (keys `<p>.lstm.*`, `<p>.lin.*`). Zero init states."""

    def __init__(self, encoding_size, hidden_size, out_elem_size, n_layers,
                 out_len):
        super().__init__()
        self.out_len = out_len
        self.n_layers = n_layers
        self.hidden_size = hidden_size
        self.lstm = nn.LSTM(encoding_size, hidden_size, n_layers,
                            batch_first=True)
        self.lin = nn.Linear(hidden_size, out_elem_size)

    def forward(self, encodings):
        B = encodings.shape[0]
        dec_input = encodings.unsqueeze(1).repeat(1, self.out_len, 1)
        h0 = torch.zeros(self.n_layers, B, self.hidden_size,
                         device=encodings.device)
        out, _ = self.lstm(dec_input, (h0, h0.clone()))
        return self.lin(out)


class TorchGarmentSegmentPattern3D(nn.Module):
    """Reference attention ('att') model at arbitrary scale, eval semantics."""

    # the forward never reads the encoder's global-pool head
    unread_state = ('feature_extractor.lin.weight', 'feature_extractor.lin.bias')

    def __init__(self, max_pattern_len=23, max_panel_len=14, element_size=4,
                 stitch_tag_dim=3, panel_encoding_size=250,
                 panel_hidden_size=250, panel_n_layers=3, econv_hidden=200,
                 econv_hidden_depth=2, econv_feature=150, k_neighbors=5,
                 conv_depth=2, skip_connections=True):
        super().__init__()
        self.max_pattern_len = max_pattern_len
        self.max_panel_len = max_panel_len
        self.element_size = element_size
        self.feature_extractor = _EdgeConvFeatures(
            panel_encoding_size, conv_depth, k_neighbors, econv_hidden,
            econv_hidden_depth, econv_feature, skip_connections)
        att_in = econv_feature + (3 if skip_connections else 0)
        # Sequential so the MLP lands at `point_segment_mlp.0` like the
        # reference's MLP+Sparsemax stack
        self.point_segment_mlp = nn.Sequential(
            _mlp([att_in, att_in, att_in, max_pattern_len]))
        self.panel_dec_lin = nn.Linear(att_in, panel_encoding_size)
        self.panel_decoder = _LSTMDecoder(
            panel_encoding_size, panel_hidden_size,
            element_size + stitch_tag_dim + 1, panel_n_layers, max_panel_len)
        self.placement_decoder = nn.Linear(panel_encoding_size, 7)

    def forward(self, positions):                            # (B, N, 3)
        B, N, _ = positions.shape
        _, point_features = self.feature_extractor(positions, pool_global=False)
        logits = self.point_segment_mlp(
            point_features.reshape(B * N, -1)).reshape(B, N, -1)
        weights = sparsemax_torch(logits)                    # (B, N, P)
        pooled = torch.einsum('bnp,bnf->bpf', weights, point_features) / N
        panel_encodings = self.panel_dec_lin(pooled)         # (B, P, E)

        flat = panel_encodings.reshape(-1, panel_encodings.shape[-1])
        panels = self.panel_decoder(flat).reshape(
            B, self.max_pattern_len, self.max_panel_len, -1)
        placement = self.placement_decoder(flat)
        return {
            'outlines': panels[..., :self.element_size],
            'stitch_tags': panels[..., self.element_size:-1],
            'free_edges_mask': panels[..., -1],
            'rotations': placement[:, :4].reshape(B, self.max_pattern_len, -1),
            'translations': placement[:, 4:].reshape(B, self.max_pattern_len, -1),
            'att_weights': weights,
        }


class TorchGarmentFullPattern3D(nn.Module):
    """Reference baseline model: global encoding -> pattern LSTM -> panel
    LSTM + placement head."""

    unread_state = ()

    def __init__(self, max_pattern_len=23, max_panel_len=14, element_size=4,
                 stitch_tag_dim=3, panel_encoding_size=250,
                 panel_hidden_size=250, panel_n_layers=3,
                 pattern_encoding_size=250, pattern_hidden_size=250,
                 pattern_n_layers=2, econv_hidden=200, econv_hidden_depth=2,
                 econv_feature=150, k_neighbors=5, conv_depth=2,
                 skip_connections=True):
        super().__init__()
        self.max_pattern_len = max_pattern_len
        self.max_panel_len = max_panel_len
        self.element_size = element_size
        self.feature_extractor = _EdgeConvFeatures(
            pattern_encoding_size, conv_depth, k_neighbors, econv_hidden,
            econv_hidden_depth, econv_feature, skip_connections)
        self.pattern_decoder = _LSTMDecoder(
            pattern_encoding_size, pattern_hidden_size, panel_encoding_size,
            pattern_n_layers, max_pattern_len)
        self.panel_decoder = _LSTMDecoder(
            panel_encoding_size, panel_hidden_size,
            element_size + stitch_tag_dim + 1, panel_n_layers, max_panel_len)
        self.placement_decoder = nn.Linear(panel_encoding_size, 7)

    def forward(self, positions):
        B = positions.shape[0]
        encoding, _ = self.feature_extractor(positions, pool_global=True)
        panel_encodings = self.pattern_decoder(encoding)      # (B, P, E)
        flat = panel_encodings.reshape(-1, panel_encodings.shape[-1])
        panels = self.panel_decoder(flat).reshape(
            B, self.max_pattern_len, self.max_panel_len, -1)
        placement = self.placement_decoder(flat)
        return {
            'outlines': panels[..., :self.element_size],
            'stitch_tags': panels[..., self.element_size:-1],
            'free_edges_mask': panels[..., -1],
            'rotations': placement[:, :4].reshape(B, self.max_pattern_len, -1),
            'translations': placement[:, 4:].reshape(B, self.max_pattern_len, -1),
        }


class TorchStitchOnEdge3DPairs(nn.Module):
    """Reference stitch pair classifier: MLP(16, 200x3, 1) with ReLU+BN after
    every layer INCLUDING the logit head (the reference's MLP quirk,
    nn/net_blocks.py:43-47 + nn/nets.py:339-340)."""

    unread_state = ()

    def __init__(self, pair_feature_len=16, hidden=200, n_layers=3):
        super().__init__()
        self.mlp = _mlp([pair_feature_len] + [hidden] * n_layers + [1])

    def forward(self, pairs):
        flat = pairs.reshape(-1, pairs.shape[-1])
        return self.mlp(flat).reshape(pairs.shape[:-1])


# ----------------------------------------------------------------------
# Reference training recipe (for the cross-framework training A/B)
# ----------------------------------------------------------------------

def torch_panel_loop_loss(outlines, num_edges, pad_vector):
    """Loop-closure prior, mirroring losses/components.panel_loop_loss
    (reference semantics: nn/metrics/losses.py:19-51): squared norm of each
    panel's un-padded edge-vector sum; panels with <3 edges contribute
    nothing but stay in the denominator."""
    panels = outlines.reshape(-1, *outlines.shape[-2:])            # (BP, L, 4)
    BP, L, _ = panels.shape
    ne = num_edges.reshape(-1)
    in_loop = torch.arange(L, device=ne.device)[None, :] < ne[:, None]  # (BP, L)
    coords = panels[..., :2] - pad_vector[:2]
    loop_sum = (coords * in_loop[..., None]).sum(dim=1)            # (BP, 2)
    loop_sum = torch.where((ne >= 3)[:, None], loop_sum,
                           torch.zeros_like(loop_sum))
    return (loop_sum ** 2).sum() / (BP * 2)


def torch_pattern_stitch_loss(stitch_tags, gt_stitches, gt_num_stitches,
                              margin=0.3, use_hardnet=False):
    """Stitch-tag contrastive loss in torch — term-for-term the same
    reductions as losses/components.pattern_stitch_loss (reference
    semantics: nn/metrics/losses.py:54-181): pull the two sides of every GT
    stitch together; push tags of different stitches >= `margin` apart."""
    B = stitch_tags.shape[0]
    S = gt_stitches.shape[-1]
    device = stitch_tags.device
    flat_tags = stitch_tags.reshape(B, -1, stitch_tags.shape[-1])  # (B, P*L, 3)

    left = torch.gather(
        flat_tags, 1,
        gt_stitches[:, 0, :, None].expand(-1, -1, flat_tags.shape[-1]))
    right = torch.gather(
        flat_tags, 1,
        gt_stitches[:, 1, :, None].expand(-1, -1, flat_tags.shape[-1]))

    stitch_valid = torch.arange(S, device=device)[None, :] \
        < gt_num_stitches[:, None]                                      # (B, S)

    sim = ((left - right) ** 2).sum(dim=-1)                             # (B, S)
    per_pattern = (sim * stitch_valid).sum(dim=1) \
        / gt_num_stitches.clamp(min=1)
    similarity_loss = per_pattern.mean()

    total_tags = torch.cat([left, right], dim=1)                        # (B, 2S, 3)
    tag_valid = torch.cat([stitch_valid, stitch_valid], dim=1)          # (B, 2S)
    dists = ((total_tags[:, :, None, :]
              - total_tags[:, None, :, :]) ** 2).sum(dim=-1)            # (B, 2S, 2S)

    idx = torch.arange(2 * S, device=device)
    self_mask = idx[:, None] == idx[None, :]
    brother = torch.where(idx < S, idx + S, idx - S)
    brother_mask = brother[:, None] == idx[None, :]
    pair_excluded = self_mask | brother_mask
    pair_valid = tag_valid[:, :, None] & tag_valid[:, None, :]

    num_valid_tags = tag_valid.sum(dim=1)                               # (B,)
    total_tag_count = num_valid_tags.sum().clamp(min=1)

    if use_hardnet:
        masked = torch.where(pair_valid & ~pair_excluded[None], dists,
                             torch.full_like(dists, float('inf')))
        min_dist = masked.min(dim=-1).values
        per_tag = (margin - min_dist).clamp(min=0.0)
        per_tag = torch.where(tag_valid & torch.isfinite(min_dist), per_tag,
                              torch.zeros_like(per_tag))
        neg_loss = per_tag.sum() / total_tag_count
    else:
        hinge = (margin - dists).clamp(min=0.0)
        hinge = torch.where(pair_valid & ~pair_excluded[None], hinge,
                            torch.zeros_like(hinge))
        per_tag = hinge.sum(dim=-1) / num_valid_tags.clamp(min=1)[:, None]
        per_tag = torch.where(tag_valid, per_tag, torch.zeros_like(per_tag))
        neg_loss = per_tag.sum() / total_tag_count

    total = similarity_loss + neg_loss
    return total, {'stitch_similarity_loss': similarity_loss,
                   'stitch_neg_loss': neg_loss}


def torch_composed_loss(preds, gt, pad_vector, loop_weight=1.0,
                        with_stitches=False, stitch_margin=0.3,
                        use_hardnet=False):
    """The published att recipe's training loss (configs/att.yaml:
    loss_components [shape, loop, rotation, translation], no order/origin
    matching) in torch — term-for-term the same means as
    losses/composed.ComposedPatternLoss._main_losses. `with_stitches`
    additionally enables the stitch-tag contrastive + free-class BCE terms
    (the post-`epoch_with_stitches` loss structure — the reference's
    nn/metrics/composed_loss.py:259-265)."""
    pattern = ((preds['outlines'] - gt['outlines']) ** 2).mean()
    loop = torch_panel_loop_loss(preds['outlines'], gt['num_edges'],
                                 pad_vector)
    rot = ((preds['rotations'] - gt['rotations']) ** 2).mean()
    transl = ((preds['translations'] - gt['translations']) ** 2).mean()
    full = pattern + loop_weight * loop + rot + transl
    terms = {'pattern_loss': pattern, 'loop_loss': loop,
             'rotation_loss': rot, 'translation_loss': transl}
    if with_stitches:
        stitch, breakdown = torch_pattern_stitch_loss(
            preds['stitch_tags'], gt['stitches'], gt['num_stitches'],
            margin=stitch_margin, use_hardnet=use_hardnet)
        free = torch.nn.functional.binary_cross_entropy_with_logits(
            preds['free_edges_mask'], gt['free_edges_mask'].float())
        full = full + stitch + free
        terms.update(breakdown, free_edges_loss=free)
    return full, terms


def _on(array, dtype, device):
    """A host array as a tensor of `dtype` on `device`."""
    return torch.from_numpy(np.asarray(array, dtype=dtype)).to(device)


def _torch_gt(gt, device):
    out = {key: _on(gt[key], np.float32, device)
           for key in ('outlines', 'rotations', 'translations')}
    out['num_edges'] = _on(gt['num_edges'], np.int64, device)
    for key in ('stitches', 'num_stitches'):
        if key in gt:
            out[key] = _on(gt[key], np.int64, device)
    if 'free_edges_mask' in gt:
        out['free_edges_mask'] = _on(gt['free_edges_mask'], np.float32, device)
    return out


def train_reference_torch(model, epoch_batches, lr_schedule, pad_vector,
                          loop_weight=1.0, on_step=None, valid_batches=None,
                          epoch_with_stitches=None, stitch_margin=0.3,
                          use_hardnet=False):
    """Train the torch replica with the reference recipe (Adam + per-step
    scheduled lr + composed loss — nn/trainer.py:162-185) on the model's
    device.

    `epoch_batches`: list (epochs) of lists of host batches — the SAME
    batch sequence the port's training loop consumes, so the two
    trajectories are directly comparable. `lr_schedule(step) -> lr` is the
    schedule the port's optimizer runs (train/trainer.py
    `cosine_onecycle_schedule`, optax's formula); torch Adam with eps=1e-8,
    betas=(0.9, 0.999) on both sides. Returns the per-step loss history.

    `valid_batches`: when given, a validation pass runs after every epoch
    and the best-validation weights are RESTORED into the model at the end
    — the reference recipe's 'best' checkpoint selection
    (nn/trainer.py:214-219).

    `epoch_with_stitches`: when not None, epochs >= it train with the
    stitch-tag contrastive + free-class BCE terms enabled — the reference's
    mid-training loss-structure change (nn/metrics/composed_loss.py:259-265;
    validation for best-checkpoint selection follows the same structure, as
    the reference trainer's valid pass does)."""
    device = _device_of(model)
    pad = _on(np.array(pad_vector, dtype=np.float32), np.float32, device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)  # lr set per step
    history = []
    best = (float('inf'), None)
    step = 0
    for epoch, batches in enumerate(epoch_batches):
        with_stitches = (epoch_with_stitches is not None
                         and epoch >= epoch_with_stitches)
        if epoch_with_stitches is not None and epoch == epoch_with_stitches:
            best = (float('inf'), None)  # loss structure changed: reset best
        model.train()
        for batch in batches:
            for group in opt.param_groups:
                group['lr'] = float(lr_schedule(step))
            opt.zero_grad()
            feats = _on(batch['features'], np.float32, device)
            preds = model(feats)
            loss, terms = torch_composed_loss(
                preds, _torch_gt(batch['ground_truth'], device), pad, loop_weight,
                with_stitches=with_stitches, stitch_margin=stitch_margin,
                use_hardnet=use_hardnet)
            loss.backward()
            opt.step()
            history.append(float(loss.detach()))
            if on_step is not None:
                on_step(step, history[-1])
            step += 1
        if valid_batches:
            model.eval()
            with torch.no_grad():
                val = float(np.mean([
                    float(torch_composed_loss(
                        model(_on(b['features'], np.float32, device)),
                        _torch_gt(b['ground_truth'], device), pad, loop_weight,
                        with_stitches=with_stitches,
                        stitch_margin=stitch_margin,
                        use_hardnet=use_hardnet)[0])
                    for b in valid_batches]))
            if val < best[0]:
                best = (val, copy.deepcopy(model.state_dict()))
    if best[1] is not None:
        model.load_state_dict(best[1])
    return history


def train_reference_stitch_torch(model, epoch_batches, lr_schedule,
                                 on_step=None, valid_batches=None):
    """Train the torch stitch pair classifier with the reference recipe:
    Adam + per-step scheduled lr + BCE-with-logits on pair labels
    (nn/trainer.py:162-185 + nn/metrics/composed_loss.py:11-126), with
    best-validation weight restoration, on the model's device.
    `epoch_batches` hold {'features': (B, NP, 16), 'ground_truth': (B, NP)}
    host batches — the SAME batch sequence the port's side consumes."""
    device = _device_of(model)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)  # lr set per step
    bce = torch.nn.functional.binary_cross_entropy_with_logits
    history = []
    best = (float('inf'), None)
    step = 0
    for batches in epoch_batches:
        model.train()
        for batch in batches:
            for group in opt.param_groups:
                group['lr'] = float(lr_schedule(step))
            opt.zero_grad()
            feats = _on(batch['features'], np.float32, device)
            labels = _on(batch['ground_truth'], np.float32, device)
            loss = bce(model(feats).reshape(-1), labels.reshape(-1))
            loss.backward()
            opt.step()
            history.append(float(loss.detach()))
            if on_step is not None:
                on_step(step, history[-1])
            step += 1
        if valid_batches:
            model.eval()
            with torch.no_grad():
                val = float(np.mean([
                    float(bce(
                        model(_on(b['features'], np.float32, device)).reshape(-1),
                        _on(b['ground_truth'], np.float32, device).reshape(-1)))
                    for b in valid_batches]))
            if val < best[0]:
                best = (val, copy.deepcopy(model.state_dict()))
    if best[1] is not None:
        model.load_state_dict(best[1])
    return history


def randomize_reference_weights(model, seed=0):
    """Non-trivial weights AND BatchNorm running stats (a fresh BN has
    mean=0/var=1, which would hide folding/import bugs); a model on the
    CPU."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.BatchNorm1d):
                module.running_mean.normal_(0, 0.2, generator=gen)
                module.running_var.uniform_(0.5, 2.0, generator=gen)
                module.weight.uniform_(0.5, 1.5, generator=gen)
                module.bias.normal_(0, 0.1, generator=gen)
            elif isinstance(module, (nn.Linear,)):
                module.weight.normal_(0, 0.3, generator=gen)
                module.bias.normal_(0, 0.1, generator=gen)
            elif isinstance(module, nn.LSTM):
                for p in module.parameters():
                    p.normal_(0, 0.2, generator=gen)
    return model
