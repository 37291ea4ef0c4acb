"""The config-driven composed loss of the pattern-shape models.

Counterpart of garment_pattern_estimation_tpu/losses/composed.py:158-447
(`ComposedPatternLoss`) for the terms the published attention config uses:
losses shape, loop, rotation, translation, segmentation (sparsemax loss),
and from `epoch_with_stitches` stitch_supervised and free_class; quality
metrics shape, discrete, rotation, translation, and free_class. Panel-order
matching, panel-origin matching, the stitch-tag loss and the stitch
precision/recall metric are not ported yet (ROADMAP queue A1) and raise
when a call would use them. `configs/att.yaml` turns the matchings off and
uses no stitch term.
"""
from __future__ import annotations

import torch

from . import components as C
from ..ops.sparsemax import sparsemax_loss

_NOT_PORTED = 'is not ported yet (ROADMAP queue A1: the losses\' GT canonicalization and stitch terms)'
_STITCH_LOSSES = ('stitch', 'stitch_supervised', 'free_class')


class ComposedPatternLoss:
    """Compound loss on pattern predictions:
    `loss(preds, ground_truth, epoch=...)` -> (full loss, dict of the terms
    and quality metrics, loss-structure-updated flag)."""

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

        # ground-truth standardization; a missing one is the identity, as in
        # the serving pipeline
        std = data_config.get('standardize', {})
        sizes = {'outlines': data_config['element_size'],
                 'rotations': data_config['rotation_size'],
                 'translations': data_config['translation_size']}
        self._stats = {name: {'shift': std.get('gt_shift', {}).get(name, [0.0] * size),
                              'scale': std.get('gt_scale', {}).get(name, [1.0] * size)}
                       for name, size in sizes.items()}
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

    def __call__(self, preds, ground_truth, epoch=1000):
        ews = self.config['epoch_with_stitches']
        if self.config['panel_order_inariant_loss']:
            raise NotImplementedError(f'ComposedPatternLoss: panel order matching {_NOT_PORTED}')
        if self.config['panel_origin_invariant_loss']:
            raise NotImplementedError(f'ComposedPatternLoss: panel origin matching {_NOT_PORTED}')
        stitch_phase = epoch >= ews and any(c in self.l_components for c in _STITCH_LOSSES)

        stats = self._stats_on(preds['outlines'].device)
        gt = ground_truth
        gt_num_edges = gt['num_edges'].long().reshape(-1)
        full_loss, loss_dict = self._main_losses(preds, gt, gt_num_edges, stats)
        if stitch_phase:
            stitch_loss, stitch_dict = self._stitch_losses(preds, gt)
            full_loss = full_loss + stitch_loss
            loss_dict.update(stitch_dict)

        if self.with_quality_eval:
            with torch.no_grad():
                detached = {k: v.detach() for k, v in preds.items()}
                quality, _ = self._main_quality_metrics(
                    detached, gt, gt_num_edges, stats)
                loss_dict.update(quality)
                if epoch >= ews:
                    loss_dict.update(self._stitch_quality_metrics(detached, gt))

        # the structure changes where the stitch losses join (order
        # matching, the other trigger, raises above)
        loss_update_ind = epoch == ews and any(c in self.l_components for c in _STITCH_LOSSES)
        return full_loss, loss_dict, loss_update_ind

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
            labels = gt['segmentation'].reshape(-1).long().clamp(0, att.shape[-1] - 1)
            segm = sparsemax_loss(att, labels).mean()
            full_loss = full_loss + self.config['segm_loss_weight'] * segm
            loss_dict['segm_loss'] = segm
        return full_loss, loss_dict

    def _stitch_losses(self, preds, gt):
        full_loss = 0.0
        loss_dict = {}
        if 'stitch' in self.l_components:
            raise NotImplementedError(f'ComposedPatternLoss: the stitch-tag loss {_NOT_PORTED}')
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

    def _stitch_quality_metrics(self, preds, gt):
        loss_dict = {}
        if 'stitch' in self.q_components:
            raise NotImplementedError(
                f'ComposedPatternLoss: the stitch precision/recall metric {_NOT_PORTED}')
        if 'free_class' in self.q_components:
            free_class = torch.round(torch.sigmoid(preds['free_edges_mask']))
            gt_mask = gt['free_edges_mask'].to(free_class.dtype)
            loss_dict['free_edge_acc'] = (free_class == gt_mask).float().mean()
        return loss_dict
