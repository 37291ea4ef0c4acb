"""The JAX package's flax variables -> the port's state dict.

`variables` is the `{'params', 'batch_stats'}` tree of a JAX pattern-shape
model (the attention model or the baseline `GarmentFullPattern3D`, with
any encoder and decoders of the JAX registries) or of the stitch model
`StitchOnEdge3DPairs` as nested dicts of numpy arrays (any array type numpy
can read). The result names its entries like the reference NeuralTailor
state dict:

    feature_extractor.conv_layers.{i}.nn.{j}.0/.2   <- conv{i}/MLP_0/Dense_j, BatchNorm_j
    feature_extractor.pool_layers.{i}.{P}           <- gpool{i}/{P}   (graph pooling)
    feature_extractor.conv{i}.nn, .pool{i}.{P}      <- conv{i}/MLP_0, pool{i}/{P}
                                                       (EdgeConvPoolingFeatures)
    feature_extractor.sa1.mlp, .mlp                 <- sa1/MLP_0, MLP_0 (PointNetPlusPlus)
    feature_extractor.lin                           <- feature_extractor/lin
    point_segment_mlp.0.{j}.0/.2                    <- point_segment_mlp/Dense_j, BatchNorm_j
    panel_dec_lin, placement_decoder                <- Dense
    {D}.lstm.{weight,bias}_{ih,hh}_l{k}             <- {D}/lstm/l{k}_{w,b}_{ih,hh}
    {D}.lstm_reverse, {D}.lstm_forward              <- {D}/lstm_reverse, lstm_forward
    {D}.recurrent_cell                              <- {D}/gru
    {D}.mlp                                         <- {D}/MLP_0  (MLPDecoder)
    {D}.lin                                         <- {D}/lin

for each pool P in att, fit_self and fit_nbr and each decoder D,
panel_decoder and pattern_decoder (the attention head `point_segment_mlp`
and `panel_dec_lin` in the attention model, `pattern_decoder` in the
baseline), the names that
garment_pattern_estimation_tpu/experiment/torch_import.py:89 reads back
for the LSTM and GRU decoders; for the stitch model

    mlp.{j}.0/.2                                    <- mlp/Dense_j, BatchNorm_j

(`torch_import.py:81` there).

Dense kernels (in, out) are transposed to (out, in); BatchNorm scale, bias,
mean and var become weight, bias, running_mean and running_var; LSTM
and GRU weights keep their (torch) layout.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch


def _tensor(value):
    return torch.from_numpy(np.array(value, dtype=np.float32, copy=True))


def _dense(sd, prefix, params):
    sd[f'{prefix}.weight'] = _tensor(np.asarray(params['kernel']).T)
    sd[f'{prefix}.bias'] = _tensor(params['bias'])


def _mlp(sd, prefix, params, stats):
    j = 0
    while f'Dense_{j}' in params:
        _dense(sd, f'{prefix}.{j}.0', params[f'Dense_{j}'])
        bn, st = params[f'BatchNorm_{j}'], stats[f'BatchNorm_{j}']
        sd[f'{prefix}.{j}.2.weight'] = _tensor(bn['scale'])
        sd[f'{prefix}.{j}.2.bias'] = _tensor(bn['bias'])
        sd[f'{prefix}.{j}.2.running_mean'] = _tensor(st['mean'])
        sd[f'{prefix}.{j}.2.running_var'] = _tensor(st['var'])
        sd[f'{prefix}.{j}.2.num_batches_tracked'] = torch.tensor(0, dtype=torch.long)
        j += 1
    if j == 0:
        raise KeyError(f'state_dict_from_flax: no MLP layers under <{prefix}>')


def _lstm(sd, prefix, params):
    """A TorchLSTM's or TorchGRU's layers: their names are the same."""
    layer = 0
    while f'l{layer}_w_ih' in params:
        for ours, theirs in (('weight_ih', 'w_ih'), ('weight_hh', 'w_hh'),
                             ('bias_ih', 'b_ih'), ('bias_hh', 'b_hh')):
            sd[f'{prefix}.{ours}_l{layer}'] = _tensor(params[f'l{layer}_{theirs}'])
        layer += 1
    if layer == 0:
        raise KeyError(f'state_dict_from_flax: no recurrent layers under <{prefix}>')


# a decoder's recurrent cells: flax name -> the port's
_DECODER_CELLS = {'lstm': 'lstm', 'lstm_reverse': 'lstm_reverse',
                  'lstm_forward': 'lstm_forward', 'gru': 'recurrent_cell'}


def _decoder(sd, name, params, stats):
    """Any decoder of the JAX registry: its cells and head, or the MLP."""
    decoder = params[name]
    if 'MLP_0' in decoder:                              # MLPDecoder
        _mlp(sd, f'{name}.mlp', decoder['MLP_0'], stats[name]['MLP_0'])
        return
    cells = [cell for cell in _DECODER_CELLS if cell in decoder]
    if not cells:
        raise KeyError(f'state_dict_from_flax: no decoder layers under <{name}>: '
                       + ', '.join(sorted(decoder)))
    for cell in cells:
        _lstm(sd, f'{name}.{_DECODER_CELLS[cell]}', decoder[cell])
    _dense(sd, f'{name}.lin', decoder['lin'])


def _graph_pool(sd, prefix, params):
    for dense in ('att', 'fit_self', 'fit_nbr'):
        _dense(sd, f'{prefix}.{dense}', params[dense])


def _encoder(sd, params, stats):
    """EdgeConvFeatures (conv0.., gpool0..), EdgeConvPoolingFeatures
    (conv1..3, pool1..2) or PointNetPlusPlus (sa1, MLP_0); the head `lin`."""
    if 'sa1' in params:
        _mlp(sd, 'feature_extractor.sa1.mlp', params['sa1']['MLP_0'], stats['sa1']['MLP_0'])
        _mlp(sd, 'feature_extractor.mlp', params['MLP_0'], stats['MLP_0'])
    elif 'pool1' in params:
        for i in (1, 2, 3):
            _mlp(sd, f'feature_extractor.conv{i}.nn', params[f'conv{i}']['MLP_0'],
                 stats[f'conv{i}']['MLP_0'])
        for i in (1, 2):
            _graph_pool(sd, f'feature_extractor.pool{i}', params[f'pool{i}'])
    else:
        conv_id = 0
        while f'conv{conv_id}' in params:
            _mlp(sd, f'feature_extractor.conv_layers.{conv_id}.nn',
                 params[f'conv{conv_id}']['MLP_0'], stats[f'conv{conv_id}']['MLP_0'])
            if f'gpool{conv_id}' in params:
                _graph_pool(sd, f'feature_extractor.pool_layers.{conv_id}',
                            params[f'gpool{conv_id}'])
            conv_id += 1
    if 'lin' in params:
        _dense(sd, 'feature_extractor.lin', params['lin'])


def state_dict_from_flax(variables) -> OrderedDict:
    """GarmentSegmentPattern3D, GarmentFullPattern3D or StitchOnEdge3DPairs
    flax variables -> the port's state dict."""
    params, stats = variables['params'], variables['batch_stats']
    sd = OrderedDict()
    if set(params) == {'mlp'}:                         # the stitch model
        _mlp(sd, 'mlp', params['mlp'], stats['mlp'])
        return sd

    _encoder(sd, params['feature_extractor'], stats['feature_extractor'])

    if 'point_segment_mlp' in params:                  # the attention model
        _mlp(sd, 'point_segment_mlp.0', params['point_segment_mlp'],
             stats['point_segment_mlp'])
        _dense(sd, 'panel_dec_lin', params['panel_dec_lin'])
    if 'pattern_decoder' in params:                    # the baseline
        _decoder(sd, 'pattern_decoder', params, stats)
    _decoder(sd, 'panel_decoder', params, stats)
    _dense(sd, 'placement_decoder', params['placement_decoder'])
    return sd
