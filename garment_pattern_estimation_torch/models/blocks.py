"""Building blocks of the attention model, eval forward.

Counterparts of garment_pattern_estimation_tpu/models/blocks.py. Parameter
names follow the reference NeuralTailor state dict (`MLP`: `{j}.0` Linear,
`{j}.2` BatchNorm1d; LSTM: `weight_ih_l{k}` ...), so the port loads a
reference checkpoint with a plain `load_state_dict`.

Train mode is not ported yet: batch statistics of the folded MLP and the
EdgeConv training kernels (`knn_gather`) come with training (ROADMAP
queue A). A module in train mode raises.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.edgeconv import fold_mlp_bn, fused_edgeconv
from ..ops.pooling import GLOBAL_POOLS

_TRAIN_NOT_PORTED = ('train mode is not ported yet (ROADMAP queue A: '
                     'knn_gather, train-mode MLP/BatchNorm); call .eval()')


class MLP(nn.ModuleList):
    """Linear -> ReLU -> BatchNorm1d stacks, BN after the activation as in
    the reference. Eval folds each BN into the next layer (`fold_mlp_bn`),
    as the JAX MLP does: the normalized tensor never materializes."""

    def __init__(self, sizes: Sequence[int], eps: float = 1e-5):
        super().__init__(
            nn.Sequential(nn.Linear(fan_in, fan_out), nn.ReLU(),
                          nn.BatchNorm1d(fan_out, eps=eps))
            for fan_in, fan_out in zip(sizes[:-1], sizes[1:]))
        self.eps = eps

    def folded(self):
        """([(W (in, out), b)], (a, d)) with every BN folded."""
        return fold_mlp_bn(
            [(s[0].weight, s[0].bias, s[2].weight, s[2].bias,
              s[2].running_mean, s[2].running_var) for s in self], self.eps)

    def forward(self, x):
        if self.training:
            raise NotImplementedError(f'MLP: {_TRAIN_NOT_PORTED}')
        layers, (a, d) = self.folded()
        for w, b in layers:
            x = torch.relu(x @ w + b)
        return x * a + d


class EdgeConv(nn.Module):
    """One dynamic EdgeConv layer, max aggregation: kNN graph on the current
    features, edge MLP on [x_i ; x_j - x_i], max over the k neighbours.
    Eval runs the fused layer (`ops.edgeconv.fused_edgeconv`)."""

    def __init__(self, in_channels: int, mlp_features: Sequence[int], k: int = 5,
                 aggr: str = 'max'):
        super().__init__()
        if aggr != 'max':
            raise NotImplementedError(
                f'EdgeConv: aggregation <{aggr}> is not ported (only max)')
        self.k = k
        self.nn = MLP([2 * in_channels, *mlp_features])

    def forward(self, x):
        if self.training:
            raise NotImplementedError(f'EdgeConv: {_TRAIN_NOT_PORTED}')
        return fused_edgeconv(x.float().contiguous(), self.nn.folded(), k=self.k)


class EdgeConvFeatures(nn.Module):
    """Stacked dynamic EdgeConv layers + optional xyz skip + optional global
    pool and linear head. Returns (global encoding | None, per-point
    features (B, N, F), mask=None)."""

    def __init__(self, out_size: int, conv_depth: int = 2, k_neighbors: int = 5,
                 econv_hidden: int = 200, econv_hidden_depth: int = 2,
                 econv_feature: int = 112, econv_aggr: str = 'max',
                 global_pool: str = 'mean', skip_connections: bool = False,
                 graph_pooling: bool = False, global_head: bool = True):
        super().__init__()
        if graph_pooling:
            raise NotImplementedError(
                'EdgeConvFeatures: graph_pooling (DynamicGraphPool) is not '
                'ported yet (ROADMAP queue A)')
        self.global_pool = global_pool
        self.skip_connections = skip_connections
        mlp = [econv_hidden] * econv_hidden_depth + [econv_feature]
        widths = [3] + [econv_feature] * conv_depth       # xyz in
        self.conv_layers = nn.ModuleList(
            EdgeConv(widths[i], mlp, k=k_neighbors, aggr=econv_aggr)
            for i in range(conv_depth))
        out_features = econv_feature + (3 if skip_connections else 0)
        # the global head exists only where the model pools globally
        self.lin = nn.Linear(out_features, out_size) if global_head else None

    def forward(self, positions, pool_global: bool = True):
        out = positions
        for conv in self.conv_layers:      # k is cut to N inside the layer
            out = conv(out)
        if self.skip_connections:
            out = torch.cat([out, positions.float()], dim=-1)
        out = out.float()
        if pool_global:
            return self.lin(GLOBAL_POOLS[self.global_pool](out)), out, None
        return None, out, None


class TorchLSTM(nn.Module):
    """Multi-layer LSTM over (B, T, C) with nn.LSTM's parameter names,
    layout and gate order (i, f, g, o), unrolled as an explicit cell loop
    like the JAX scan."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        for layer in range(n_layers):
            fan_in = input_size if layer == 0 else hidden_size
            self.register_parameter(
                f'weight_ih_l{layer}', nn.Parameter(torch.empty(4 * hidden_size, fan_in)))
            self.register_parameter(
                f'weight_hh_l{layer}', nn.Parameter(torch.empty(4 * hidden_size, hidden_size)))
            self.register_parameter(
                f'bias_ih_l{layer}', nn.Parameter(torch.empty(4 * hidden_size)))
            self.register_parameter(
                f'bias_hh_l{layer}', nn.Parameter(torch.empty(4 * hidden_size)))

    def forward(self, inputs, init_states):
        """inputs (B, T, C); init_states: [(h0, c0)] per layer. Returns
        (outputs (B, T, H), [(h, c)] final states per layer)."""
        x = inputs
        final_states = []
        for layer in range(self.n_layers):
            w_ih = getattr(self, f'weight_ih_l{layer}')
            w_hh = getattr(self, f'weight_hh_l{layer}')
            # the input projection of the whole sequence at once
            gates_x = x @ w_ih.t() + getattr(self, f'bias_ih_l{layer}') \
                + getattr(self, f'bias_hh_l{layer}')
            h, c = init_states[layer]
            outs = []
            for step in range(x.shape[1]):
                gates = gates_x[:, step] + h @ w_hh.t()
                i, f, g, o = gates.chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                outs.append(h)
            x = torch.stack(outs, dim=1)
            final_states.append((h, c))
        return x, final_states


class LSTMDecoderModule(nn.Module):
    """Encoding -> sequence: the encoding repeated `out_len` times feeds the
    LSTM, a linear head maps hidden states to elements. Eval starts from
    zero states (the JAX module's states without a 'recurrent_init' rng);
    the reference's random initial states are a training-time noise."""

    def __init__(self, encoding_size: int, hidden_size: int, out_elem_size: int,
                 n_layers: int, out_len: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.out_len = out_len
        self.lstm = TorchLSTM(encoding_size, hidden_size, n_layers)
        self.lin = nn.Linear(hidden_size, out_elem_size)

    def forward(self, encodings, out_len=None):
        if self.training:
            raise NotImplementedError(f'LSTMDecoderModule: {_TRAIN_NOT_PORTED}')
        out_len = out_len or self.out_len
        B = encodings.shape[0]
        dec_input = encodings[:, None, :].expand(B, out_len, encodings.shape[-1])
        zeros = encodings.new_zeros(B, self.hidden_size)
        out, _ = self.lstm(dec_input, [(zeros, zeros)] * self.n_layers)
        return self.lin(out)


DECODER_REGISTRY = {
    'LSTMDecoderModule': LSTMDecoderModule,
}

ENCODER_REGISTRY = {
    'EdgeConvFeatures': EdgeConvFeatures,
}
