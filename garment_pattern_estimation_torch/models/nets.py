"""The NeuralTailor pattern-shape models, eval and train forward
(`module.eval()` / `module.train()`, both with the outputs below): the
baseline `GarmentFullPattern3D` and the attention model
`GarmentSegmentPattern3D`, its subclass.

Counterpart of garment_pattern_estimation_tpu/models/nets.py:27-235.
Predictions are a dict:
    outlines        (B, P, L, element_size)
    rotations       (B, P, rotation_size)
    translations    (B, P, translation_size)
    stitch_tags     (B, P, L, stitch_tag_dim)
    free_edges_mask (B, P, L) logits
    att_weights     (B, N, P) sparsemax scores (attention model only)

and the stitch model `StitchOnEdge3DPairs`, a pair classifier whose output
is one logit per 16-float edge pair (`:238-252` there).
"""
from __future__ import annotations

import torch
from torch import nn

from . import blocks
from ..ops.pooling import GLOBAL_POOLS
from ..ops.sparsemax import sparsemax


class GarmentFullPattern3DModule(nn.Module):
    """Baseline NeuralTailor shape model: the encoder pools the cloud into
    one encoding, the pattern LSTM unrolls it into `max_pattern_size` panel
    encodings, and the shared panel LSTM unrolls each into edges beside a
    linear placement head. `edgeconv_train_chunk` and `edgeconv_train_mode`
    set the chunked EdgeConv training path of every conv layer (NN config
    keys of the same names); `compute_dtype` (bf16) is the mixed-precision
    mode of the encoder's MLPs, less the conv ids in `f32_conv_layers`
    (garment_pattern_estimation_tpu/models/nets.py:66-75). The decoders,
    the placement head and the loss stay f32."""

    def __init__(self, *, pattern_hidden_size=250, pattern_n_layers=2,
                 pattern_decoder='LSTMDecoderModule', **shared):
        super().__init__()
        if pattern_decoder not in blocks.DECODER_REGISTRY:
            raise NotImplementedError(
                f'GarmentFullPattern3D: decoder <{pattern_decoder}> is not '
                'ported yet (ROADMAP queue A)')
        self._setup_shared(global_head=True, **shared)
        self.pattern_decoder = blocks.DECODER_REGISTRY[pattern_decoder](
            encoding_size=self.pattern_encoding_size, hidden_size=pattern_hidden_size,
            out_elem_size=self.panel_encoding_size, n_layers=pattern_n_layers,
            out_len=self.max_pattern_size, dropout=self.dropout, state_init=self.lstm_init)

    def _setup_shared(self, *, global_head, element_size=4, max_panel_len=14,
                      max_pattern_size=23, rotation_size=4, translation_size=3,
                      panel_encoding_size=250, panel_hidden_size=250, panel_n_layers=3,
                      pattern_encoding_size=250, stitch_tag_dim=3, dropout=0.0,
                      lstm_init='kaiming_normal_', feature_extractor='EdgeConvFeatures',
                      panel_decoder='LSTMDecoderModule', conv_depth=2, k_neighbors=5,
                      econv_hidden=200, econv_hidden_depth=2, econv_feature=112,
                      econv_aggr='max', global_pool='mean', skip_connections=False,
                      graph_pooling=False, edgeconv_train_chunk=None,
                      edgeconv_train_mode='fused_final', compute_dtype=None,
                      f32_conv_layers=()):
        """The encoder (its global head `lin` with `global_head`), the panel
        decoder and the placement head, which both models build alike."""
        if feature_extractor not in blocks.ENCODER_REGISTRY:
            raise NotImplementedError(
                f'{type(self).__name__}: encoder <{feature_extractor}> is not '
                'ported yet (ROADMAP queue A)')
        if panel_decoder not in blocks.DECODER_REGISTRY:
            raise NotImplementedError(
                f'{type(self).__name__}: decoder <{panel_decoder}> is not '
                'ported yet (ROADMAP queue A)')
        self.element_size = element_size
        self.max_panel_len = max_panel_len
        self.max_pattern_size = max_pattern_size
        self.rotation_size = rotation_size
        self.panel_encoding_size = panel_encoding_size
        self.pattern_encoding_size = pattern_encoding_size
        self.dropout = dropout
        self.lstm_init = lstm_init
        self.econv_feature = econv_feature
        self.skip_connections = skip_connections
        self.global_pool = global_pool

        self.feature_extractor = blocks.ENCODER_REGISTRY[feature_extractor](
            out_size=pattern_encoding_size, conv_depth=conv_depth,
            k_neighbors=k_neighbors, econv_hidden=econv_hidden,
            econv_hidden_depth=econv_hidden_depth, econv_feature=econv_feature,
            econv_aggr=econv_aggr, global_pool=global_pool,
            skip_connections=skip_connections, graph_pooling=graph_pooling,
            global_head=global_head, train_chunk_size=edgeconv_train_chunk,
            train_mode=edgeconv_train_mode, compute_dtype=compute_dtype,
            f32_conv_layers=f32_conv_layers)
        # each decoded edge element: outline + stitch tag + free-edge logit
        self.panel_decoder = blocks.DECODER_REGISTRY[panel_decoder](
            encoding_size=panel_encoding_size, hidden_size=panel_hidden_size,
            out_elem_size=element_size + stitch_tag_dim + 1,
            n_layers=panel_n_layers, out_len=max_panel_len, dropout=dropout,
            state_init=lstm_init)
        self.placement_decoder = nn.Linear(panel_encoding_size,
                                           rotation_size + translation_size)

    def encode(self, positions):
        """The global encoding (B, pattern_encoding_size)."""
        encoding, _, _ = self.feature_extractor(positions, pool_global=True)
        return encoding

    def decode_panels(self, flat_panel_encodings, batch_size, generator=None):
        flat_panels = self.panel_decoder(flat_panel_encodings, generator=generator)
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

    def forward(self, positions, generator=None):
        """`generator` (train or eval mode): the source of both LSTM
        decoders' random initial states, the pattern decoder's drawn first,
        and of the train-mode dropout masks; without it the states are
        zeros."""
        panel_encodings = self.pattern_decoder(self.encode(positions), generator=generator)
        return self.decode_panels(panel_encodings.reshape(-1, panel_encodings.shape[-1]),
                                  positions.shape[0], generator)


class GarmentSegmentPattern3DModule(GarmentFullPattern3DModule):
    """NeuralTailor attention model: per-point MLP + sparsemax route point
    features into `max_pattern_size` panel slots; the pooled per-panel
    features are projected and take the pattern decoder's place. Under
    `compute_dtype` the attention MLP is bf16 too, unless
    `f32_attention_mlp` (garment_pattern_estimation_tpu/models/nets.py:186-190).
    Sparsemax stays f32."""

    def __init__(self, *, local_attention=True, f32_attention_mlp=False, **shared):
        nn.Module.__init__(self)          # the pattern decoder is not built
        self._setup_shared(global_head=not local_attention, **shared)
        self.local_attention = local_attention

        att_in = self.econv_feature
        if not local_attention:
            att_in += self.pattern_encoding_size
        if self.skip_connections:
            att_in += 3                     # raw xyz concatenated by the encoder
        self.point_segment_mlp = nn.Sequential(blocks.MLP(
            [att_in, att_in, att_in, self.max_pattern_size],
            compute_dtype=None if f32_attention_mlp else shared.get('compute_dtype')))
        self.panel_dec_lin = nn.Linear(self.econv_feature + (3 if self.skip_connections else 0),
                                       self.panel_encoding_size)

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

    def forward(self, positions, generator=None):
        """`generator` (train or eval mode): the source of the LSTM
        decoder's random initial states; without it they are zeros."""
        B = positions.shape[0]
        panel_encodings, att_weights = self.panel_encodings_from_3d(positions)
        preds = self.decode_panels(
            panel_encodings.reshape(-1, panel_encodings.shape[-1]), B, generator)
        preds['att_weights'] = att_weights
        return preds


class StitchOnEdge3DPairsModule(nn.Module):
    """Binary stitch classifier on edge pairs: (..., pair_feature_len) ->
    (...) logits through `blocks.MLP`, with ReLU + BatchNorm after every
    layer, the logit's included (the reference MLP's layout, kept so its
    checkpoints behave the same). In train mode the BN statistics come from
    all the rows of the flattened batch, as flax's BatchNorm reduces every
    leading axis."""

    def __init__(self, pair_feature_len=16, stitch_hidden_size=200, stitch_mlp_n_layers=3):
        super().__init__()
        self.mlp = blocks.MLP([pair_feature_len]
                              + [stitch_hidden_size] * stitch_mlp_n_layers + [1])

    def forward(self, pairs, generator=None):
        """`generator` is not used: it is taken so that the trainer calls
        every model the same way."""
        return self.mlp(pairs.reshape(-1, pairs.shape[-1])).reshape(pairs.shape[:-1])
