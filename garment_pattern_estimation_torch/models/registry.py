"""Model factory: name + configs -> the experiment-facing model object.

Counterpart of garment_pattern_estimation_tpu/models/registry.py:99-171 for
the attention model: class defaults <- YAML NN section <- backfilled
compatibility keys, the merged dict kept for experiment tracking, and the
composed loss from the registry's loss defaults <- the loss section
(`:49-58`, `:118-134` there). Weights are drawn from a seeded
`torch.Generator`; the model is built in eval mode on the resolved device.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_compute_dtype, resolve_device
from ..losses import ComposedPatternLoss
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

# merged-config keys the attention model's module does not take: the
# pattern decoder is the other family's, pool_ratio belongs to graph
# pooling (not ported)
_UNUSED_BY_MODULE = ('pattern_hidden_size', 'pattern_n_layers', 'pattern_decoder',
                     'pool_ratio')


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
    do. Only 'GarmentSegmentPattern3D' is ported."""
    device = resolve_device(device)
    nn_config = dict(nn_config or {})
    nn_config.pop('loss', None)
    compute_dtype = nn_config.pop('compute_dtype', None)
    f32_conv_layers = tuple(nn_config.pop('f32_conv_layers', ()) or ())
    f32_attention_mlp = bool(nn_config.pop('f32_attention_mlp', False))
    edgeconv_train_chunk = nn_config.pop('edgeconv_train_chunk', None)
    edgeconv_train_mode = nn_config.pop('edgeconv_train_mode', 'fused_final')
    resolve_compute_dtype(compute_dtype)           # raises on any other dtype

    if model_name != 'GarmentSegmentPattern3D':
        if model_name in ('GarmentFullPattern3D', 'StitchOnEdge3DPairs'):
            raise NotImplementedError(
                f'build_model: <{model_name}> is not ported yet (ROADMAP queue A)')
        raise ValueError(f'models.registry::unknown model <{model_name}>')

    config = dict(_SHAPE_MODEL_DEFAULTS)
    config['local_attention'] = False          # old-run default (reference nets.py)
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
        if key not in _UNUSED_BY_MODULE:
            module_kwargs[_FIELD_MAP.get(key, key)] = value
    module = nets.GarmentSegmentPattern3DModule(**module_kwargs)
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
