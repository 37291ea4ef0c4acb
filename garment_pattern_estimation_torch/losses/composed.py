"""The config-driven composed loss of the pattern-shape models, with the
ground-truth canonicalization it runs first, and the stitch model's loss.

Counterpart of garment_pattern_estimation_tpu/losses/composed.py:31-451
(`ComposedPatternLoss` and its primitives): losses shape, loop, rotation,
translation, segmentation (sparsemax loss), and from `epoch_with_stitches`
stitch (the stitch-tag loss), stitch_supervised and free_class; quality
metrics shape, discrete, rotation, translation, stitch (precision/recall of
the decoded stitches) and free_class.

The GT canonicalization (panel-order matching by a greedy global-min
assignment, panel loop-origin matching, the stitch ids renumbered after
both) runs as masked tensor ops on the predictions' device, and its loops
(P steps of the assignment) make no host synchronization. Every argmin
takes the first minimum, as the JAX one does: padded GT panels are equal,
so their distances tie exactly.

`ComposedLoss` is the stitch pair classifier's
(garment_pattern_estimation_tpu/losses/composed.py:454-517).
"""
from __future__ import annotations

import torch

from . import components as C
from .stitches import stitch_precision_recall
from ..ops.sparsemax import sparsemax_loss

_STITCH_LOSSES = ('stitch', 'stitch_supervised', 'free_class')
_INF = float('inf')


# ======================================================================
# GT canonicalization primitives
# ======================================================================

def greedy_order_match(pred_features, gt_features):
    """Greedy global-min assignment of GT panels to predicted panel slots:
    P steps, each taking every pattern's closest remaining (slot, panel)
    pair (the first of equal distances). Returns the permutation (B, P)
    int64: the new GT panel at slot p is the old panel perm[p]."""
    B, P = pred_features.shape[:2]
    pred = pred_features.reshape(B, P, -1)
    gt = gt_features.reshape(B, P, -1)
    dist = torch.sqrt(torch.clamp_min(
        (pred ** 2).sum(-1)[:, :, None] + (gt ** 2).sum(-1)[:, None, :]
        - 2 * torch.einsum('bpf,bqf->bpq', pred, gt), 0.0))

    slots = torch.arange(P, device=dist.device)
    perm = torch.zeros(B, P, dtype=torch.long, device=dist.device)
    for _ in range(P):
        flat_min = dist.reshape(B, -1).argmin(dim=1)
        rows, cols = flat_min // P, flat_min % P
        taken_row = slots[None, :] == rows[:, None]                 # (B, P)
        taken_col = slots[None, :] == cols[:, None]
        perm = torch.where(taken_row, cols[:, None], perm)
        dist = torch.where(taken_row[:, :, None] | taken_col[:, None, :], _INF, dist)
    return perm


def permute_panels(features, permutation):
    """Gather panel-axis features (B, P, ...) by the permutation (B, P)."""
    idx = permutation.long().reshape(permutation.shape + (1,) * (features.dim() - 2))
    return torch.gather(features, 1, idx.expand(permutation.shape + features.shape[2:]))


def renumber_stitches_after_permute(stitches, num_stitches, permutation, max_panel_len):
    """Re-map pattern-level edge ids (B, 2, S) after a panel permutation;
    ids past each pattern's `num_stitches` stay as they are."""
    inverse = torch.argsort(permutation, dim=1)                   # (B, P)
    stitches = stitches.long()
    panel_id = (stitches // max_panel_len).clamp(0, permutation.shape[1] - 1)
    in_edge = stitches % max_panel_len
    new_panel = torch.gather(inverse[:, None, :].expand(-1, 2, -1), 2, panel_id)
    new_ids = new_panel * max_panel_len + in_edge
    valid = torch.arange(stitches.shape[-1], device=stitches.device)[None, None, :] \
        < num_stitches[:, None, None]
    return torch.where(valid, new_ids, stitches)


def _loop_sources(num_edges, shifts, L):
    """Source edge of each slot when each panel's loop starts at `shifts`
    (broadcast against the slot axis): (slot + shift) mod the panel's edge
    count inside the loop, the slot itself on the padding."""
    ne = num_edges.long()
    slots = torch.arange(L, device=ne.device)
    ne_b = ne.reshape(ne.shape + (1,) * (shifts.dim() - 1))
    return torch.where(slots < ne_b, (slots + shifts) % torch.clamp_min(ne_b, 1), slots)


def match_panel_origins(pred_outlines, gt_outlines, gt_num_edges):
    """Pick, per panel, the GT edge-loop rotation with the smallest squared
    error to the prediction (the smallest shift among equal errors).
    Returns (rotated GT outlines (B, P, L, E), leading edges (B*P,))."""
    B, P, L, E = gt_outlines.shape
    pred = pred_outlines.reshape(-1, L, E)
    gt = gt_outlines.reshape(-1, L, E)
    BP = gt.shape[0]
    ne = gt_num_edges.reshape(-1).long()
    shifts = torch.arange(L, device=gt.device)[None, :, None]    # (1, L shifts, 1)
    src = _loop_sources(ne, shifts, L)                             # (BP, L, L)
    shifted = torch.gather(gt[:, None].expand(BP, L, L, E), 2,
                           src[..., None].expand(BP, L, L, E))      # (BP, shift, slot, E)
    dists = ((pred[:, None] - shifted) ** 2).sum(dim=(2, 3))      # (BP, L)
    shift_valid = torch.arange(L, device=gt.device)[None, :] < torch.clamp_min(ne, 1)[:, None]
    leading = torch.where(shift_valid, dists, _INF).argmin(dim=1)
    chosen = torch.gather(shifted, 1, leading[:, None, None, None].expand(BP, 1, L, E))[:, 0]
    return chosen.reshape(B, P, L, E), leading


def shift_panel_features(features, leading_edges, gt_num_edges):
    """Roll each panel's per-edge features (B, P, L, ...) so its leading
    edge comes first, padding in place; panels with < 3 edges untouched."""
    B, P, L = features.shape[:3]
    flat = features.reshape(B * P, L, -1)
    ne = gt_num_edges.reshape(-1).long()
    src = _loop_sources(ne, leading_edges.reshape(-1, 1).long(), L)    # (BP, L)
    shifted = torch.gather(flat, 1, src[..., None].expand(flat.shape))
    shifted = torch.where((ne >= 3)[:, None, None], shifted, flat)
    return shifted.reshape(features.shape)


def renumber_stitches_after_shift(stitches, num_stitches, leading_edges,
                                  gt_num_edges, max_num_panels, max_panel_len):
    """Re-map pattern-level edge ids (B, 2, S) after per-panel loop-origin
    shifts; ids past each pattern's `num_stitches` stay as they are."""
    B, _, S = stitches.shape
    lead = leading_edges.reshape(B, max_num_panels).long()
    ne = gt_num_edges.reshape(B, max_num_panels).long()
    stitches = stitches.long()
    panel_id = (stitches // max_panel_len).clamp(0, max_num_panels - 1)
    in_edge = stitches % max_panel_len
    panel_lead = torch.gather(lead[:, None, :].expand(-1, 2, -1), 2, panel_id)
    panel_ne = torch.gather(ne[:, None, :].expand(-1, 2, -1), 2, panel_id)
    new_in_edge = torch.where(in_edge >= panel_lead, in_edge - panel_lead,
                              panel_ne - (panel_lead - in_edge))
    new_ids = panel_id * max_panel_len + new_in_edge
    valid = torch.arange(S, device=stitches.device)[None, None, :] < num_stitches[:, None, None]
    return torch.where(valid, new_ids, stitches)


def random_permutations(generator, batch_size, num_panels, device=None):
    """(batch_size, num_panels) int64, each row a uniform random permutation
    drawn from `generator` (the argsort of uniform draws), on `device`."""
    draws = torch.rand(batch_size, num_panels, generator=generator, device=generator.device)
    return torch.argsort(draws, dim=1).to(device or generator.device)


# ======================================================================
# Shape-model composed loss
# ======================================================================

class ComposedPatternLoss:
    """Compound loss on pattern predictions:
    `loss(preds, ground_truth, epoch=..., generator=...)` -> (full loss,
    dict of the terms and quality metrics, loss-structure-updated flag).

    `points_shard` (None, or the `parallel.mesh.PointsShard` that `Trainer`
    sets under a data x points mesh where the attention weights are this
    rank's points of each cloud): the segmentation term reads this rank's
    points of the GT labels and is the mean over every rank's points (its
    local sum summed over the points ranks), the same on every rank."""

    def __init__(self, data_config, in_config=None):
        self.config = {
            'loss_components': ['shape'],
            'quality_components': [],
            'loop_loss_weight': 1.0,
            'segm_loss_weight': 0.05,
            'stitch_tags_margin': 0.3,
            'epoch_with_stitches': 40,
            'stitch_supervised_weight': 0.1,
            'stitch_hardnet_version': False,
            'panel_origin_invariant_loss': True,
            'panel_order_inariant_loss': True,   # (sic) key kept for config compat
            'order_by': 'placement',
            'epoch_with_order_matching': 0,
        }
        self.config.update(in_config or {})
        self.with_quality_eval = True
        self.l_components = tuple(self.config['loss_components'])
        self.q_components = tuple(self.config['quality_components'])
        self.max_panel_len = data_config['max_panel_len']
        self.max_pattern_size = data_config['max_pattern_len']
        self.explicit_stitch_tags = data_config.get('explicit_stitch_tags', False)
        self.points_shard = None

        # ground-truth standardization; a missing one is the identity, as in
        # the serving pipeline
        std = data_config.get('standardize', {})
        sizes = {'outlines': data_config['element_size'],
                 'rotations': data_config['rotation_size'],
                 'translations': data_config['translation_size']}
        self._stats = {name: {'shift': std.get('gt_shift', {}).get(name, [0.0] * size),
                              'scale': std.get('gt_scale', {}).get(name, [1.0] * size)}
                       for name, size in sizes.items()}
        # the tags' statistics un-standardize explicit tags for the stitch
        # metric; there is no identity default for them, as in the JAX loss
        if 'stitch_tags' in std.get('gt_shift', {}):
            self._stats['stitch_tags'] = {'shift': std['gt_shift']['stitch_tags'],
                                          'scale': std['gt_scale']['stitch_tags']}
        self._on_device = {}

    def _stats_on(self, device):
        """The standardization statistics and the pad vector as f32 tensors
        on `device`, made once per device."""
        if device not in self._on_device:
            on = {name: {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                         for k, v in s.items()} for name, s in self._stats.items()}
            on['pad_vector'] = C.eval_pad_vector(self._stats['outlines']).to(device)
            self._on_device[device] = on
        return self._on_device[device]

    def __call__(self, preds, ground_truth, epoch=1000, generator=None):
        """`generator` draws the random GT panel order of the epochs before
        `epoch_with_order_matching` (the JAX loss's `rng`); those epochs
        raise without one."""
        ews = self.config['epoch_with_stitches']
        stitch_phase = epoch >= ews and any(c in self.l_components for c in _STITCH_LOSSES)
        # GT stitch ids and free-edge masks follow the panel permutation and
        # the loop rotation whenever anything reads them this epoch, the
        # quality metrics included
        track_stitches = stitch_phase or (
            self.with_quality_eval and epoch >= ews
            and any(c in self.q_components for c in ('stitch', 'free_class')))

        stats = self._stats_on(preds['outlines'].device)
        gt = dict(ground_truth)
        if self.config['panel_order_inariant_loss']:
            if 'segmentation' in self.l_components:
                raise NotImplementedError(
                    'Order matching not supported for training with segmentation losses')
            gt = self._gt_order_match(preds, gt, epoch, track_stitches, generator)
        gt_num_edges = gt['num_edges'].long().reshape(-1)
        if self.config['panel_origin_invariant_loss']:
            gt = self._rotate_gt(preds, gt, gt_num_edges, track_stitches)

        full_loss, loss_dict = self._main_losses(preds, gt, gt_num_edges, stats)
        if stitch_phase:
            stitch_loss, stitch_dict = self._stitch_losses(preds, gt)
            full_loss = full_loss + stitch_loss
            loss_dict.update(stitch_dict)

        if self.with_quality_eval:
            with torch.no_grad():
                detached = {k: v.detach() for k, v in preds.items()}
                quality, correct_mask = self._main_quality_metrics(
                    detached, gt, gt_num_edges, stats)
                loss_dict.update(quality)
                if epoch >= ews:
                    loss_dict.update(self._stitch_quality_metrics(
                        detached, gt, correct_mask, stats))

        loss_update_ind = (
            (epoch == ews and any(c in self.l_components for c in _STITCH_LOSSES))
            or (epoch == self.config['epoch_with_order_matching']
                and self.config['panel_order_inariant_loss']))
        return full_loss, loss_dict, loss_update_ind

    # ------------- GT order matching -------------
    def _order_features(self, preds, gt, epoch):
        order_by = self.config['order_by']
        if order_by == 'placement':
            return (torch.cat([preds['translations'], preds['rotations']], -1),
                    torch.cat([gt['translations'], gt['rotations']], -1))
        if order_by == 'translation':
            return preds['translations'], gt['translations']
        if order_by == 'shape_translation':
            B, P = preds['outlines'].shape[:2]
            return (torch.cat([preds['translations'], preds['outlines'].reshape(B, P, -1)], -1),
                    torch.cat([gt['translations'], gt['outlines'].reshape(B, P, -1)], -1))
        if order_by == 'stitches':
            pred_f = torch.cat([preds['translations'], preds['rotations']], -1)
            gt_f = torch.cat([gt['translations'], gt['rotations']], -1)
            if epoch >= self.config['epoch_with_stitches']:
                B, P = preds['free_edges_mask'].shape[:2]
                pred_mask = torch.round(torch.sigmoid(preds['free_edges_mask'])).reshape(B, P, -1)
                gt_mask = gt['free_edges_mask'].reshape(B, P, -1).float()
                pred_f = torch.cat([pred_f, pred_mask], -1)
                gt_f = torch.cat([gt_f, gt_mask], -1)
            return pred_f, gt_f
        raise NotImplementedError(
            f'ComposedPatternLoss::ordering by <{order_by}> is not implemented')

    def _gt_order_match(self, preds, gt, epoch, track_stitches, generator):
        pred_f, gt_f = self._order_features(preds, gt, epoch)
        pred_f = pred_f.detach()
        if epoch < self.config['epoch_with_order_matching']:
            if generator is None:
                raise ValueError('ComposedPatternLoss::random-order warmup phase '
                                 'requires a generator')
            perm = random_permutations(generator, pred_f.shape[0], pred_f.shape[1],
                                       pred_f.device)
        else:
            perm = greedy_order_match(pred_f, gt_f)

        updated = dict(gt)
        for key in ('outlines', 'num_edges', 'empty_panels_mask'):
            updated[key] = permute_panels(gt[key], perm)
        if 'rotation' in self.l_components:
            updated['rotations'] = permute_panels(gt['rotations'], perm)
        if 'translation' in self.l_components:
            updated['translations'] = permute_panels(gt['translations'], perm)
        if track_stitches:
            updated['stitches'] = renumber_stitches_after_permute(
                gt['stitches'], gt['num_stitches'], perm, self.max_panel_len)
            updated['free_edges_mask'] = permute_panels(gt['free_edges_mask'], perm)
            if 'stitch_supervised' in self.l_components:
                updated['stitch_tags'] = permute_panels(gt['stitch_tags'], perm)
        return updated

    # ------------- GT loop-origin matching -------------
    def _rotate_gt(self, preds, gt, gt_num_edges, track_stitches):
        updated = dict(gt)
        updated['outlines'], leading = match_panel_origins(
            preds['outlines'].detach(), gt['outlines'], gt_num_edges)
        if track_stitches:
            updated['stitches'] = renumber_stitches_after_shift(
                gt['stitches'], gt['num_stitches'], leading, gt_num_edges,
                self.max_pattern_size, self.max_panel_len)
            updated['free_edges_mask'] = shift_panel_features(
                gt['free_edges_mask'][..., None], leading, gt_num_edges)[..., 0]
            if 'stitch_supervised' in self.l_components:
                updated['stitch_tags'] = shift_panel_features(
                    gt['stitch_tags'], leading, gt_num_edges)
        return updated

    def _main_losses(self, preds, gt, gt_num_edges, stats):
        full_loss = 0.0
        loss_dict = {}
        if 'shape' in self.l_components:
            pattern_loss = ((preds['outlines'] - gt['outlines']) ** 2).mean()
            full_loss = full_loss + pattern_loss
            loss_dict['pattern_loss'] = pattern_loss
        if 'loop' in self.l_components:
            loop = C.panel_loop_loss(preds['outlines'], gt_num_edges, stats['pad_vector'])
            full_loss = full_loss + self.config['loop_loss_weight'] * loop
            loss_dict['loop_loss'] = loop
        if 'rotation' in self.l_components:
            rot = ((preds['rotations'] - gt['rotations']) ** 2).mean()
            full_loss = full_loss + rot
            loss_dict['rotation_loss'] = rot
        if 'translation' in self.l_components:
            transl = ((preds['translations'] - gt['translations']) ** 2).mean()
            full_loss = full_loss + transl
            loss_dict['translation_loss'] = transl
        if 'segmentation' in self.l_components:
            att = preds['att_weights'].reshape(-1, preds['att_weights'].shape[-1])
            labels = gt['segmentation']
            if self.points_shard is not None:
                labels = self.points_shard.local(labels)
            labels = labels.reshape(-1).long().clamp(0, att.shape[-1] - 1)
            segm = sparsemax_loss(att, labels)
            segm = segm.mean() if self.points_shard is None \
                else self.points_shard.mean(segm.sum(), segm.numel())
            full_loss = full_loss + self.config['segm_loss_weight'] * segm
            loss_dict['segm_loss'] = segm
        return full_loss, loss_dict

    def _stitch_losses(self, preds, gt):
        full_loss = 0.0
        loss_dict = {}
        if 'stitch' in self.l_components:
            stitch_loss, breakdown = C.pattern_stitch_loss(
                preds['stitch_tags'], gt['stitches'], gt['num_stitches'],
                margin=self.config['stitch_tags_margin'],
                use_hardnet=self.config['stitch_hardnet_version'])
            full_loss = full_loss + stitch_loss
            loss_dict.update(breakdown)
        if 'stitch_supervised' in self.l_components:
            sup = ((preds['stitch_tags'] - gt['stitch_tags']) ** 2).mean()
            full_loss = full_loss + self.config['stitch_supervised_weight'] * sup
            loss_dict['stitch_supervised_loss'] = sup
        if 'free_class' in self.l_components:
            free = C.bce_with_logits(preds['free_edges_mask'], gt['free_edges_mask'])
            full_loss = full_loss + free
            loss_dict['free_edges_loss'] = free
        return full_loss, loss_dict

    def _main_quality_metrics(self, preds, gt, gt_num_edges, stats):
        loss_dict = {}
        correct_mask = None
        if 'discrete' in self.q_components:
            panel_acc, edge_acc, correct_mask, corr_edge_acc = \
                C.numbers_in_panels_accuracies(
                    preds['outlines'], gt_num_edges, gt['num_panels'],
                    stats['pad_vector'], stats['outlines']['scale'])
            loss_dict.update(num_panels_accuracy=panel_acc, num_edges_accuracy=edge_acc,
                             corr_num_edges_accuracy=corr_edge_acc)
        if 'shape' in self.q_components:
            shape_l2, corr_shape_l2 = C.panel_verts_l2(
                preds['outlines'], gt['outlines'], gt_num_edges,
                stats['outlines']['shift'], stats['outlines']['scale'], correct_mask)
            loss_dict.update(panel_shape_l2=shape_l2, corr_panel_shape_l2=corr_shape_l2)
        if 'rotation' in self.q_components:
            rot_l2, corr_rot_l2 = C.universal_l2(
                preds['rotations'], gt['rotations'], stats['rotations']['shift'],
                stats['rotations']['scale'], correct_mask)
            loss_dict.update(rotation_l2=rot_l2, corr_rotation_l2=corr_rot_l2)
        if 'translation' in self.q_components:
            transl_l2, corr_transl_l2 = C.universal_l2(
                preds['translations'], gt['translations'],
                stats['translations']['shift'], stats['translations']['scale'],
                correct_mask)
            loss_dict.update(translation_l2=transl_l2, corr_translation_l2=corr_transl_l2)
        return loss_dict, correct_mask

    def _stitch_quality_metrics(self, preds, gt, correct_mask, stats):
        loss_dict = {}
        if 'stitch' in self.q_components:
            tags = preds['stitch_tags']
            if self.explicit_stitch_tags and 'stitch_tags' in stats:
                tags = tags * stats['stitch_tags']['scale'] + stats['stitch_tags']['shift']
            # decode capacity E // 2: every edge may be paired, as in the
            # reference's unbounded greedy loop
            n_edges = tags.shape[1] * tags.shape[2]
            prec, rec, corr_prec, corr_rec = stitch_precision_recall(
                tags, preds['free_edges_mask'], gt['stitches'], gt['num_stitches'],
                max_stitches=max(n_edges // 2, 2), correct_mask=correct_mask)
            loss_dict.update(stitch_precision=prec, stitch_recall=rec,
                             corr_stitch_precision=corr_prec, corr_stitch_recall=corr_rec)
        if 'free_class' in self.q_components:
            free_class = torch.round(torch.sigmoid(preds['free_edges_mask']))
            gt_mask = gt['free_edges_mask'].to(free_class.dtype)
            loss_dict['free_edge_acc'] = (free_class == gt_mask).float().mean()
        return loss_dict


# ======================================================================
# Stitch-model composed loss
# ======================================================================

class ComposedLoss:
    """The stitch pair classifier's loss: BCE on the pair logits
    (`edge_pair_class`), and as quality metrics the accuracy
    (`edge_pair_class`), stitch precision and recall
    (`edge_pair_stitch_recall`) of round(sigmoid(logit)). The metrics stay
    on the logits' device."""

    def __init__(self, data_config, in_config=None):
        self.config = {'loss_components': [], 'quality_components': []}
        self.config.update(in_config or {})
        self.with_quality_eval = True
        self.training = False
        self.l_components = tuple(self.config['loss_components'])
        self.q_components = tuple(self.config['quality_components'])

    def __call__(self, preds, ground_truth, epoch=1000, generator=None, mask=None):
        """`mask` (the shape of `preds`, optional) marks the real pairs of a
        batch padded to a shape bucket: a padded pair counts in no mean and
        no count. `epoch` and `generator` are not used. Returns (loss, dict,
        False)."""
        loss_dict = {}
        full_loss = torch.zeros((), device=preds.device)
        valid = None if mask is None else mask.reshape(-1)
        if 'edge_pair_class' in self.l_components:
            pair_loss = C.bce_with_logits(preds.reshape(-1), ground_truth.reshape(-1),
                                          mask=valid)
            loss_dict['edge_pair_class_loss'] = pair_loss
            full_loss = full_loss + pair_loss

        if self.with_quality_eval:
            with torch.no_grad():
                pred_class = torch.round(torch.sigmoid(preds.detach())).reshape(-1)
                gt_mask = ground_truth.reshape(-1).to(pred_class.dtype)
                if valid is not None:
                    # padded slots: predicted 0 against gt 0 (no tp, fp or
                    # fn), and out of the accuracy's mean
                    pred_class = torch.where(valid, pred_class, 0.0)
                    gt_mask = torch.where(valid, gt_mask, 0.0)
                if 'edge_pair_class' in self.q_components:
                    correct = (pred_class == gt_mask).float()
                    loss_dict['edge_pair_class_acc'] = correct.mean() if valid is None \
                        else (torch.where(valid, correct, 0.0).sum()
                              / torch.clamp_min(valid.sum(), 1))
                if 'edge_pair_stitch_recall' in self.q_components:
                    true_pos = ((pred_class == 1) & (gt_mask == 1)).sum().float()
                    pred_pos = (pred_class == 1).sum().float()
                    actual_pos = (gt_mask == 1).sum().float()
                    loss_dict['stitch_precision'] = torch.where(
                        pred_pos > 0, true_pos / torch.clamp_min(pred_pos, 1), 0.0)
                    loss_dict['stitch_recall'] = torch.where(
                        actual_pos > 0, true_pos / torch.clamp_min(actual_pos, 1), 0.0)
        return full_loss, loss_dict, False

    def eval(self):
        self.training = False

    def train(self, mode=True):
        self.training = mode
