"""Building blocks of the pattern-shape models, eval and train forward.

Counterparts of garment_pattern_estimation_tpu/models/blocks.py. Parameter
names follow the reference NeuralTailor state dict (`MLP`: `{j}.0` Linear,
`{j}.2` BatchNorm1d; LSTM: `weight_ih_l{k}` ...), so the port loads a
reference checkpoint with a plain `load_state_dict`.

EdgeConv routes as the JAX layer does. Eval folds each BatchNorm's running
statistics into the next layer and runs the fused kernel up to 16384 points
(single-tile up to 2048, column-tiled beyond); past that, the unfused path:
the standalone kNN, the neighbour gather and the edge MLP. Train computes
each BatchNorm's batch statistics: through `knn_gather` (kernels for the kNN
+ gather and its backward) and the edge MLP in PyTorch up to 2048 points,
the unfused path beyond, and the chunked rematerialized sweeps
(`ops.edgeconv_train`) when the widest per-edge tensor would pass 2 GB.

`compute_dtype=bfloat16` is the mixed-precision mode of
garment_pattern_estimation_tpu/models/blocks.py:84-166 and :196-356: the
MLP products and ReLUs in bf16 (parameters, statistics, BN affines and
running averages f32), the fused layer with bf16 gathered rows, knn_gather
with one value chunk, the chunked sweeps in bf16; the kNN stays f32.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..device import resolve_compute_dtype
from ..ops.edgeconv import fold_mlp_bn, fused_edgeconv, fused_edgeconv_supported
from ..ops.edgeconv_train import MODES as TRAIN_MODES, chunked_edgeconv_train
from ..ops.knn import knn as knn_search
from ..ops.knn_gather import knn_gather, knn_gather_supported
from ..ops.pooling import GLOBAL_POOLS, gather_neighbors

BN_MOMENTUM = 0.1           # running = 0.9 * running + 0.1 * batch (flax momentum 0.9)


@torch.no_grad()
def _update_running(bn, mean, var):
    bn.running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
    bn.running_var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var)


def _first_edge_layer(edge_pair, W, b, dtype=None):
    """relu of the first layer on the EdgeConv input [x_i ; x_j - x_i]
    factored as (center (B, N, C), neighbours, the neighbours' slot axis):
    center @ (W_top - W_bot) + b + neighbours @ W_bot, so the (..., 2C)
    edge tensor never materializes. `dtype` (bf16) casts center,
    neighbours, W and b to it first."""
    center, neighbours, axis = edge_pair
    if dtype is not None:
        center, neighbours, W, b = (t.to(dtype) for t in (center, neighbours, W, b))
    C = center.shape[-1]
    point_term = center @ (W[:C] - W[C:]) + b                    # (B, N, H)
    return torch.relu(point_term.unsqueeze(axis) + neighbours @ W[C:])


class MLP(nn.ModuleList):
    """Linear -> ReLU -> BatchNorm1d stacks, BN after the activation as in
    the reference. Every BN is folded into the next layer (the last one
    into a final affine), as the JAX MLP does: the normalized tensor never
    materializes. Eval folds the running statistics (`fold_mlp_bn`).

    Train folds the batch statistics: the mean and the biased variance in
    f32 of each ReLU output over every leading axis (flax BatchNorm
    semantics; torch's BatchNorm1d would keep the unbiased variance in its
    running average), and updates the running averages in place;
    `update_running_stats` does the same update from statistics computed
    elsewhere (the chunked EdgeConv sweeps). The `edge_pair` form of the
    first layer, in both modes, takes the EdgeConv input factored as
    (center (B, N, C), neighbours (B, k, N, C) or (B, N, k, C), the slot
    axis 1 or 2) (`_first_edge_layer`).

    `compute_dtype` (bf16) casts where the JAX MLP casts, in both modes:
    each product's input, folded W and folded b go to bf16 (the fold
    itself, a W and d @ W + b, in f32), the ReLU runs in bf16, statistics
    come from the f32 upcast, and the final affine x * a + d runs in f32
    and is cast to bf16."""

    def __init__(self, sizes: Sequence[int], eps: float = 1e-5, compute_dtype=None):
        super().__init__(
            nn.Sequential(nn.Linear(fan_in, fan_out), nn.ReLU(),
                          nn.BatchNorm1d(fan_out, eps=eps))
            for fan_in, fan_out in zip(sizes[:-1], sizes[1:]))
        self.eps = eps
        self.compute_dtype = resolve_compute_dtype(compute_dtype)

    def folded(self):
        """([(W (in, out), b)], (a, d)) with every BN folded."""
        return fold_mlp_bn(
            [(s[0].weight, s[0].bias, s[2].weight, s[2].bias,
              s[2].running_mean, s[2].running_var) for s in self], self.eps)

    def update_running_stats(self, stats):
        """Each BN's running averages from external (mean, biased var)
        pairs, one per layer, at the train forward's momentum."""
        for (_, _, bn), (mean, var) in zip(self, stats):
            _update_running(bn, mean, var)

    def _affine(self, x, a, d):
        """The last BN as the f32 affine, cast back to the compute dtype."""
        out = x.float() * a + d
        return out if self.compute_dtype is None else out.to(self.compute_dtype)

    def _layer(self, x, W, b):
        """relu(x @ W + b), at the compute dtype."""
        if self.compute_dtype is not None:
            x, W, b = (t.to(self.compute_dtype) for t in (x, W, b))
        return torch.relu(x @ W + b)

    def forward(self, x=None, edge_pair=None):
        if self.training:
            return self._train_forward(x, edge_pair)
        layers, (a, d) = self.folded()
        for i, (w, b) in enumerate(layers):
            x = _first_edge_layer(edge_pair, w, b, self.compute_dtype) \
                if i == 0 and edge_pair is not None else self._layer(x, w, b)
        return self._affine(x, a, d)

    def _train_forward(self, x, edge_pair):
        pending = None                          # the previous BN's (a, d)
        for i, (linear, _, bn) in enumerate(self):
            W, b = linear.weight.t(), linear.bias
            if i == 0 and edge_pair is not None:
                x = _first_edge_layer(edge_pair, W, b, self.compute_dtype)
            elif pending is not None:
                a, d = pending
                x = self._layer(x, a[:, None] * W, d @ W + b)
            else:
                x = self._layer(x, W, b)
            xf = x.float()
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dim=dims)
            var = torch.clamp_min((xf * xf).mean(dim=dims) - mean * mean, 0.0)
            _update_running(bn, mean, var)
            a = bn.weight * torch.rsqrt(var + self.eps)
            d = bn.bias - mean * a
            pending = (a, d)
        return self._affine(x, *pending)


class EdgeConv(nn.Module):
    """One dynamic EdgeConv layer, max aggregation: kNN graph on the current
    features, edge MLP on [x_i ; x_j - x_i], max over the k neighbours.

    Routing, as garment_pattern_estimation_tpu/models/blocks.py:196-284:
      * train, chunked (`train_chunked`, None = when B N k max(C, widths) 4
        bytes pass `_CHUNK_TRAIN_BYTES`): `knn` on the detached input, then
        `ops.edgeconv_train.chunked_edgeconv_train` (`train_chunk_size`
        queries per sweep step, `train_mode` its schedule), then the
        running statistics from its (mean, var) pairs;
      * train, N <= 2048: `knn_gather` (kernels on the card) and the edge
        MLP on the slot-major (B, k, N, C) rows;
      * train past 2048 points and eval past 16384: `knn`,
        `gather_neighbors` and the edge MLP on (B, N, k, C);
      * eval up to 16384 points: the fused layer `fused_edgeconv`.
    `compute_dtype` (bf16) reaches the MLP, the chunked sweeps, the fused
    layer's `mlp_dtype` (its output stays f32) and knn_gather's one value
    chunk; the kNN runs on the f32 upcast of the input on every path (a
    bf16 input, the previous layer's output, upcasts exactly).
    """

    # the unfused path materializes (B, N, k, W) for the widest W among the
    # gathered C and the hidden widths; past 2 GB (the 128 x 10k stress
    # configuration) only the chunked sweeps fit
    _CHUNK_TRAIN_BYTES = 1 << 31

    def __init__(self, in_channels: int, mlp_features: Sequence[int], k: int = 5,
                 aggr: str = 'max', train_chunked: bool | None = None,
                 train_chunk_size: int | None = None, train_mode: str = 'fused_final',
                 compute_dtype=None):
        super().__init__()
        if aggr != 'max':
            raise NotImplementedError(
                f'EdgeConv: aggregation <{aggr}> is not ported (only max)')
        if train_mode not in TRAIN_MODES:
            raise ValueError(f'unknown EdgeConv train mode {train_mode!r}')
        self.k = k
        self.mlp_features = list(mlp_features)
        self.train_chunked = train_chunked
        self.train_chunk_size = train_chunk_size
        self.train_mode = train_mode
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.nn = MLP([2 * in_channels, *mlp_features], compute_dtype=self.compute_dtype)

    def chunked(self, B, N, C):
        """Whether train mode takes the chunked sweeps for a (B, N, C) input."""
        if self.train_chunked is not None:
            return self.train_chunked
        widest = max([C, *self.mlp_features])
        return B * N * min(self.k, N) * widest * 4 > self._CHUNK_TRAIN_BYTES

    def forward(self, x):
        x = x.float().contiguous()
        B, N, C = x.shape
        k = min(self.k, N)
        bf16 = self.compute_dtype == torch.bfloat16
        if self.training:
            if self.chunked(B, N, C):
                idx = knn_search(x.detach(), k)
                out, stats = chunked_edgeconv_train(
                    x, idx, self.nn, chunk=self.train_chunk_size, mode=self.train_mode,
                    compute_dtype=self.compute_dtype)
                self.nn.update_running_stats(stats)
                return out
            if knn_gather_supported(N):
                # bf16: the gathered rows and their cotangents in one chunk
                neighbours, _ = knn_gather(x, k, value_chunks=1 if bf16 else 2)
                return torch.amax(self.nn(edge_pair=(x, neighbours, 1)), dim=1)
        elif fused_edgeconv_supported(N, C):
            return fused_edgeconv(x, self.nn.folded(), k=self.k,
                                  mlp_dtype=torch.bfloat16 if bf16 else torch.float32)
        neighbours = gather_neighbors(x, knn_search(x.detach(), k))    # (B, N, k, C)
        return torch.amax(self.nn(edge_pair=(x, neighbours, 2)), dim=2)


class EdgeConvFeatures(nn.Module):
    """Stacked dynamic EdgeConv layers + optional xyz skip + optional global
    pool and linear head. Returns (global encoding | None, per-point
    features (B, N, F) f32, mask=None). `train_chunk_size` and `train_mode`
    reach every layer (`EdgeConv`), and `compute_dtype` every layer whose
    id is not in `f32_conv_layers` (those stay f32)."""

    def __init__(self, out_size: int, conv_depth: int = 2, k_neighbors: int = 5,
                 econv_hidden: int = 200, econv_hidden_depth: int = 2,
                 econv_feature: int = 112, econv_aggr: str = 'max',
                 global_pool: str = 'mean', skip_connections: bool = False,
                 graph_pooling: bool = False, global_head: bool = True,
                 train_chunk_size: int | None = None, train_mode: str = 'fused_final',
                 compute_dtype=None, f32_conv_layers: Sequence[int] = ()):
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
            EdgeConv(widths[i], mlp, k=k_neighbors, aggr=econv_aggr,
                     train_chunk_size=train_chunk_size, train_mode=train_mode,
                     compute_dtype=None if i in tuple(f32_conv_layers) else compute_dtype)
            for i in range(conv_depth))
        out_features = econv_feature + (3 if skip_connections else 0)
        # the global head exists only where the model pools globally
        self.lin = nn.Linear(out_features, out_size) if global_head else None

    def forward(self, positions, pool_global: bool = True):
        out = positions
        for conv in self.conv_layers:      # k is cut to N inside the layer
            out = conv(out)
        if self.skip_connections:
            out = torch.cat([out.to(positions.dtype), positions], dim=-1)
        out = out.float()                  # the heads and the loss stay f32
        if pool_global:
            return self.lin(GLOBAL_POOLS[self.global_pool](out)), out, None
        return None, out, None


def inverted_dropout(x, rate, generator=None):
    """flax's `nn.Dropout(rate)` in train mode: each element kept with
    probability 1 - rate and scaled by 1 / (1 - rate), else zero. The mask
    is drawn from `generator` (torch's default generator without one)."""
    device = x.device if generator is None else generator.device
    keep = torch.rand(x.shape, generator=generator, device=device).to(x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


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

    def forward(self, inputs, init_states, dropout=0.0, generator=None):
        """inputs (B, T, C); init_states: [(h0, c0)] per layer. Returns
        (outputs (B, T, H), [(h, c)] final states per layer). `dropout` > 0
        drops that share of each layer's output but the last's
        (`inverted_dropout`, masks from `generator`)."""
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
            if dropout > 0 and layer < self.n_layers - 1:
                x = inverted_dropout(x, dropout, generator)
        return x, final_states


class LSTMDecoderModule(nn.Module):
    """Encoding -> sequence: the encoding repeated `out_len` times feeds the
    LSTM, a linear head maps hidden states to elements. In train mode
    `dropout` acts between the LSTM layers, as in the JAX package's
    `TorchLSTM`.

    Initial states: with 'kaiming_normal' in `state_init` and a `generator`
    from the caller, fresh normal states of std sqrt(2 / (batch * hidden))
    on every forward, in train and eval mode alike (the reference's noise,
    drawn h then c per layer, as the JAX package's `_init_states` draws
    whenever it has the 'recurrent_init' rng); zeros without a generator
    (serving)."""

    def __init__(self, encoding_size: int, hidden_size: int, out_elem_size: int,
                 n_layers: int, out_len: int, dropout: float = 0.0,
                 state_init: str = 'kaiming_normal'):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.out_len = out_len
        self.dropout = float(dropout or 0)
        self.state_init = state_init or ''
        self.lstm = TorchLSTM(encoding_size, hidden_size, n_layers)
        self.lin = nn.Linear(hidden_size, out_elem_size)

    def initial_states(self, batch_size, device, generator=None):
        """[(h0, c0)] per layer, (batch_size, hidden) each."""
        if generator is not None and 'kaiming_normal' in self.state_init:
            std = math.sqrt(2.0 / (batch_size * self.hidden_size))

            def draw():
                return (torch.randn(batch_size, self.hidden_size, generator=generator,
                                    device=generator.device) * std).to(device)
            return [(draw(), draw()) for _ in range(self.n_layers)]
        zeros = torch.zeros(batch_size, self.hidden_size, device=device)
        return [(zeros, zeros)] * self.n_layers

    def forward(self, encodings, out_len=None, generator=None):
        """`generator` also draws the train-mode dropout masks between the
        LSTM layers, after the initial states."""
        out_len = out_len or self.out_len
        B = encodings.shape[0]
        dec_input = encodings[:, None, :].expand(B, out_len, encodings.shape[-1])
        out, _ = self.lstm(dec_input, self.initial_states(B, encodings.device, generator),
                           dropout=self.dropout if self.training else 0.0,
                           generator=generator)
        return self.lin(out)


DECODER_REGISTRY = {
    'LSTMDecoderModule': LSTMDecoderModule,
}

ENCODER_REGISTRY = {
    'EdgeConvFeatures': EdgeConvFeatures,
}
