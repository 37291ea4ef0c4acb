"""The NeuralTailor attention model, `GarmentSegmentPattern3D`, eval forward.

Counterpart of garment_pattern_estimation_tpu/models/nets.py:169-235 (and
`decode_panels` of its parent). Predictions are a dict:
    outlines        (B, P, L, element_size)
    rotations       (B, P, rotation_size)
    translations    (B, P, translation_size)
    stitch_tags     (B, P, L, stitch_tag_dim)
    free_edges_mask (B, P, L) logits
    att_weights     (B, N, P) sparsemax scores
"""
from __future__ import annotations

import torch
from torch import nn

from . import blocks
from ..ops.pooling import GLOBAL_POOLS
from ..ops.sparsemax import sparsemax


class GarmentSegmentPattern3DModule(nn.Module):
    """Per-point MLP + sparsemax route point features into
    `max_pattern_size` panel slots; the pooled per-panel features are
    projected and decoded panel by panel by the LSTM panel decoder."""

    def __init__(self, *, element_size=4, max_panel_len=14, max_pattern_size=23,
                 rotation_size=4, translation_size=3, panel_encoding_size=250,
                 panel_hidden_size=250, panel_n_layers=3, pattern_encoding_size=250,
                 stitch_tag_dim=3,
                 feature_extractor='EdgeConvFeatures',
                 panel_decoder='LSTMDecoderModule', conv_depth=2, k_neighbors=5,
                 econv_hidden=200, econv_hidden_depth=2, econv_feature=112,
                 econv_aggr='max', global_pool='mean', skip_connections=False,
                 graph_pooling=False, local_attention=True):
        super().__init__()
        if feature_extractor not in blocks.ENCODER_REGISTRY:
            raise NotImplementedError(
                f'GarmentSegmentPattern3D: encoder <{feature_extractor}> is not '
                'ported yet (ROADMAP queue A)')
        if panel_decoder not in blocks.DECODER_REGISTRY:
            raise NotImplementedError(
                f'GarmentSegmentPattern3D: decoder <{panel_decoder}> is not '
                'ported yet (ROADMAP queue A)')
        self.element_size = element_size
        self.max_panel_len = max_panel_len
        self.max_pattern_size = max_pattern_size
        self.rotation_size = rotation_size
        self.global_pool = global_pool
        self.local_attention = local_attention

        self.feature_extractor = blocks.ENCODER_REGISTRY[feature_extractor](
            out_size=pattern_encoding_size, conv_depth=conv_depth,
            k_neighbors=k_neighbors, econv_hidden=econv_hidden,
            econv_hidden_depth=econv_hidden_depth, econv_feature=econv_feature,
            econv_aggr=econv_aggr, global_pool=global_pool,
            skip_connections=skip_connections, graph_pooling=graph_pooling,
            global_head=not local_attention)
        self.panel_decoder = blocks.DECODER_REGISTRY[panel_decoder](
            encoding_size=panel_encoding_size, hidden_size=panel_hidden_size,
            out_elem_size=element_size + stitch_tag_dim + 1,
            n_layers=panel_n_layers, out_len=max_panel_len)
        self.placement_decoder = nn.Linear(panel_encoding_size,
                                           rotation_size + translation_size)

        att_in = econv_feature
        if not local_attention:
            att_in += pattern_encoding_size
        if skip_connections:
            att_in += 3                     # raw xyz concatenated by the encoder
        self.point_segment_mlp = nn.Sequential(
            blocks.MLP([att_in, att_in, att_in, max_pattern_size]))
        self.panel_dec_lin = nn.Linear(econv_feature + (3 if skip_connections else 0),
                                       panel_encoding_size)

    def decode_panels(self, flat_panel_encodings, batch_size):
        flat_panels = self.panel_decoder(flat_panel_encodings)
        flat_placement = self.placement_decoder(flat_panel_encodings)

        panels = flat_panels.reshape(
            batch_size, self.max_pattern_size, self.max_panel_len, -1)
        rotations = flat_placement[:, :self.rotation_size].reshape(
            batch_size, self.max_pattern_size, -1)
        translations = flat_placement[:, self.rotation_size:].reshape(
            batch_size, self.max_pattern_size, -1)
        return {
            'outlines': panels[..., :self.element_size],
            'rotations': rotations, 'translations': translations,
            'stitch_tags': panels[..., self.element_size:-1],
            'free_edges_mask': panels[..., -1],
        }

    def panel_encodings_from_3d(self, positions):
        """(panel encodings (B, P, E), attention weights (B, N, P))."""
        B = positions.shape[0]
        global_enc, point_features, _ = self.feature_extractor(
            positions, pool_global=not self.local_attention)
        N = point_features.shape[1]

        if self.local_attention:
            att_input = point_features
        else:
            propagated = global_enc[:, None, :].expand(B, N, global_enc.shape[-1])
            att_input = torch.cat([propagated, point_features], dim=-1)

        logits = self.point_segment_mlp(att_input.reshape(B * N, -1)).reshape(B, N, -1)
        weights = sparsemax(logits.float())                              # (B, N, P)

        # mean/add pools contract over N as one product; max needs the
        # per-panel weighted features
        if self.global_pool in ('mean', 'add'):
            pooled = torch.einsum('bnp,bnf->bpf', weights, point_features)
            if self.global_pool == 'mean':
                pooled = pooled / N
        else:
            weighted = torch.einsum('bnp,bnf->bpnf', weights, point_features)
            pooled = GLOBAL_POOLS[self.global_pool](
                weighted.reshape(B * self.max_pattern_size, N, -1)) \
                .reshape(B, self.max_pattern_size, -1)
        return self.panel_dec_lin(pooled), weights

    def forward(self, positions):
        B = positions.shape[0]
        panel_encodings, att_weights = self.panel_encodings_from_3d(positions)
        preds = self.decode_panels(
            panel_encodings.reshape(-1, panel_encodings.shape[-1]), B)
        preds['att_weights'] = att_weights
        return preds
