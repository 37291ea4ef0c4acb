"""Model factory: name + configs -> the experiment-facing model object.

Counterpart of garment_pattern_estimation_tpu/models/registry.py:99-186 for
the pattern-shape models (`GarmentFullPattern3D`, the baseline, and
`GarmentSegmentPattern3D`, the attention model) and the stitch model
(`StitchOnEdge3DPairs`): class defaults <- YAML NN section <- backfilled
compatibility keys, the merged dict kept for experiment tracking, and the
composed loss from the registry's loss defaults <- the loss section
(`:49-67`, `:118-134`, `:173-186` there). Weights are drawn from a seeded
`torch.Generator`; the model is built in eval mode on the resolved device.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_compute_dtype, resolve_device
from ..losses import ComposedLoss, ComposedPatternLoss
from . import blocks, nets

# YAML / reference config key -> module argument
_FIELD_MAP = {
    'EConv_hidden': 'econv_hidden',
    'EConv_hidden_depth': 'econv_hidden_depth',
    'EConv_feature': 'econv_feature',
    'EConv_aggr': 'econv_aggr',
}

_SHAPE_MODEL_DEFAULTS = {
    'panel_encoding_size': 250,
    'panel_hidden_size': 250,
    'panel_n_layers': 3,
    'pattern_encoding_size': 250,
    'pattern_hidden_size': 250,
    'pattern_n_layers': 2,
    'dropout': 0,
    'lstm_init': 'kaiming_normal_',
    'feature_extractor': 'EdgeConvFeatures',
    'panel_decoder': 'LSTMDecoderModule',
    'pattern_decoder': 'LSTMDecoderModule',
    'stitch_tag_dim': 3,
    'conv_depth': 2,
    'k_neighbors': 5,
    'EConv_hidden': 200,
    'EConv_hidden_depth': 2,
    'EConv_feature': 112,
    'EConv_aggr': 'max',
    'global_pool': 'mean',
    'skip_connections': False,
    'graph_pooling': False,
    'pool_ratio': 0.1,
}

_SHAPE_LOSS_DEFAULTS = {
    'loss_components': ['shape', 'loop', 'rotation', 'translation'],
    'quality_components': ['shape', 'discrete', 'rotation', 'translation'],
    'loop_loss_weight': 1.0,
    'stitch_tags_margin': 0.3,
    'epoch_with_stitches': 40,
    'stitch_supervised_weight': 0.1,
    'stitch_hardnet_version': False,
    'panel_origin_invariant_loss': True,
}

_STITCH_MODEL_DEFAULTS = {
    'stitch_hidden_size': 200,
    'stitch_mlp_n_layers': 3,
}

_STITCH_LOSS_DEFAULTS = {
    'loss_components': ['edge_pair_class'],
    'quality_components': ['edge_pair_class', 'edge_pair_stitch_recall'],
    'panel_origin_invariant_loss': False,
    'panel_order_inariant_loss': False,
}

# merged-config keys a model's module does not take: pool_ratio belongs to
# graph pooling (not ported); the attention model has no pattern decoder,
# the baseline no attention head
_UNUSED_BY_MODULE = {
    'GarmentFullPattern3D': ('pool_ratio', 'local_attention', 'f32_attention_mlp'),
    'GarmentSegmentPattern3D': ('pool_ratio', 'pattern_hidden_size', 'pattern_n_layers',
                                'pattern_decoder'),
}
_MODULES = {'GarmentFullPattern3D': nets.GarmentFullPattern3DModule,
            'GarmentSegmentPattern3D': nets.GarmentSegmentPattern3DModule}


class GarmentModel:
    """The module, its merged config and its composed loss, as the JAX
    package's `GarmentModel` bundles them."""

    def __init__(self, name, module, config, loss):
        self.name = name
        self.module = module
        self.config = config
        self.loss = loss

    @property
    def device(self):
        return next(self.module.parameters()).device

    def __call__(self, features):
        return self.module(features)


def init_weights(module: nn.Module, seed: int = 0):
    """Seeded init in the JAX package's scheme: Dense kernels lecun-normal
    (std sqrt(1/fan_in)), biases zero, BatchNorm identity statistics, LSTM
    weights kaiming-normal (std sqrt(2/fan_in)) and biases U(+-1/sqrt(H))."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / math.sqrt(m.weight.shape[1]))
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm1d):
                m.reset_parameters()
            elif isinstance(m, blocks.TorchLSTM):
                bound = 1.0 / math.sqrt(m.hidden_size)
                for name, p in m.named_parameters():
                    if name.startswith('weight'):
                        p.copy_(torch.randn(p.shape, generator=gen)
                                * math.sqrt(2.0 / p.shape[1]))
                    else:
                        p.copy_(torch.rand(p.shape, generator=gen) * 2 * bound - bound)


def build_model(model_name, data_config, nn_config=None, loss_config=None, *,
                device=None, seed=0):
    """Construct a model family by its reference name, on `device`
    (None = CUDA; raises when CUDA is missing and the CPU was not asked for),
    with its composed loss (`loss_config`: the NN section's `loss`).

    The NN section's `compute_dtype` (None, 'float32' or 'bfloat16'; any
    other raises ValueError), `f32_conv_layers` and `f32_attention_mlp` set
    the mixed-precision mode (parameters stay f32), as the JAX registry's
    do. 'StitchOnEdge3DPairs' takes its pair length from
    `data_config['element_size']` and only the NN keys of its defaults."""
    device = resolve_device(device)
    nn_config = dict(nn_config or {})
    nn_config.pop('loss', None)
    compute_dtype = nn_config.pop('compute_dtype', None)
    f32_conv_layers = tuple(nn_config.pop('f32_conv_layers', ()) or ())
    f32_attention_mlp = bool(nn_config.pop('f32_attention_mlp', False))
    edgeconv_train_chunk = nn_config.pop('edgeconv_train_chunk', None)
    edgeconv_train_mode = nn_config.pop('edgeconv_train_mode', 'fused_final')
    resolve_compute_dtype(compute_dtype)           # raises on any other dtype

    if model_name == 'StitchOnEdge3DPairs':
        return _build_stitch_model(data_config, nn_config, loss_config, device, seed)
    if model_name not in _MODULES:
        raise ValueError(f'models.registry::unknown model <{model_name}>')

    config = dict(_SHAPE_MODEL_DEFAULTS)
    if model_name == 'GarmentSegmentPattern3D':
        config['local_attention'] = False      # old-run default (reference nets.py)
    if 'panel_hidden_size' not in nn_config and 'panel_encoding_size' in nn_config:
        nn_config['panel_hidden_size'] = nn_config['panel_encoding_size']
    if 'pattern_hidden_size' not in nn_config and 'pattern_encoding_size' in nn_config:
        nn_config['pattern_hidden_size'] = nn_config['pattern_encoding_size']
    config.update({k: v for k, v in nn_config.items()
                   if k in config or k == 'local_attention'})

    module_kwargs = dict(
        element_size=data_config['element_size'],
        max_panel_len=data_config['max_panel_len'],
        max_pattern_size=data_config['max_pattern_len'],
        rotation_size=data_config['rotation_size'],
        translation_size=data_config['translation_size'],
        edgeconv_train_chunk=edgeconv_train_chunk,
        edgeconv_train_mode=edgeconv_train_mode,
        compute_dtype=compute_dtype,
        f32_conv_layers=f32_conv_layers,
        f32_attention_mlp=f32_attention_mlp,
    )
    for key, value in config.items():
        module_kwargs[_FIELD_MAP.get(key, key)] = value
    for key in _UNUSED_BY_MODULE[model_name]:
        module_kwargs.pop(key, None)
    module = _MODULES[model_name](**module_kwargs)
    init_weights(module, seed)
    module = module.to(device).eval()
    loss = ComposedPatternLoss(data_config, {**_SHAPE_LOSS_DEFAULTS, **(loss_config or {})})

    merged = dict(config)
    merged['model'] = model_name
    merged['loss'] = loss.config
    merged['compute_dtype'] = compute_dtype
    merged['f32_conv_layers'] = list(f32_conv_layers)
    merged['f32_attention_mlp'] = f32_attention_mlp
    merged['edgeconv_train_chunk'] = edgeconv_train_chunk
    merged['edgeconv_train_mode'] = edgeconv_train_mode
    return GarmentModel(model_name, module, merged, loss)


def _build_stitch_model(data_config, nn_config, loss_config, device, seed):
    """The stitch model, merged config and loss as the JAX registry builds
    them (garment_pattern_estimation_tpu/models/registry.py:173-186)."""
    config = dict(_STITCH_MODEL_DEFAULTS)
    config.update({k: v for k, v in nn_config.items() if k in config})
    loss = ComposedLoss(data_config, {**_STITCH_LOSS_DEFAULTS, **(loss_config or {})})
    module = nets.StitchOnEdge3DPairsModule(
        pair_feature_len=data_config['element_size'],
        stitch_hidden_size=config['stitch_hidden_size'],
        stitch_mlp_n_layers=config['stitch_mlp_n_layers'])
    init_weights(module, seed)
    merged = dict(config)
    merged['model'] = 'StitchOnEdge3DPairs'
    merged['loss'] = loss.config
    return GarmentModel('StitchOnEdge3DPairs', module.to(device).eval(), merged, loss)
