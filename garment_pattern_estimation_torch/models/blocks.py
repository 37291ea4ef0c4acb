"""Building blocks of the pattern-shape models, eval and train forward.

Counterparts of garment_pattern_estimation_tpu/models/blocks.py: every
encoder (`EdgeConvFeatures`, with or without graph pooling,
`EdgeConvPoolingFeatures`, `PointNetPlusPlus`) and decoder (the LSTM,
double-reverse LSTM, GRU and MLP decoders, the LSTM encoder) of its
registries. Parameter names follow the reference NeuralTailor state dict
(`MLP`: `{j}.0` Linear, `{j}.2` BatchNorm1d; LSTM and GRU: `weight_ih_l{k}`
...), so the port loads a reference checkpoint with a plain
`load_state_dict`.

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

import contextlib
import contextvars
import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ..device import resolve_compute_dtype
from ..ops.edgeconv import fold_mlp_bn, fused_edgeconv, fused_edgeconv_supported
from ..ops.edgeconv_train import MODES as TRAIN_MODES, chunked_edgeconv_train
from ..ops.knn import knn as knn_search, pairwise_sq_dists
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
    and is cast to bf16.

    `data_shard` (None, or a `parallel.DataShard` that `Trainer` sets under
    a data mesh): the train forward's statistics are the means over the
    mesh's ranks of each rank's moments, those of the global batch, and
    the chunked sweeps' too (`ops.edgeconv_train`), each rank's weighed by
    its rows where the points ranks hold uneven counts (`DataShard.mean`)."""

    def __init__(self, sizes: Sequence[int], eps: float = 1e-5, compute_dtype=None):
        super().__init__(
            nn.Sequential(nn.Linear(fan_in, fan_out), nn.ReLU(),
                          nn.BatchNorm1d(fan_out, eps=eps))
            for fan_in, fan_out in zip(sizes[:-1], sizes[1:]))
        self.eps = eps
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.data_shard = None

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

    def _moments(self, x):
        """(mean, biased variance) in f32 of each channel of `x` over every
        leading axis, as E[x^2] - E[x]^2 (as the JAX MLP); under a
        `data_shard` the moments of the rows of every rank."""
        xf = x.float()
        dims = tuple(range(x.dim() - 1))
        mean, sq = xf.mean(dim=dims), (xf * xf).mean(dim=dims)
        if self.data_shard is not None:
            rows = xf.numel() // xf.shape[-1]
            mean, sq = self.data_shard.mean(torch.stack([mean, sq]), rows)
        return mean, torch.clamp_min(sq - mean * mean, 0.0)

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
            mean, var = self._moments(x)
            _update_running(bn, mean, var)
            a = bn.weight * torch.rsqrt(var + self.eps)
            d = bn.bias - mean * a
            pending = (a, d)
        return self._affine(x, *pending)


def points_pool(kind, features, shard=None, dim=1):
    """GLOBAL_POOLS[kind] over the point axis `dim` of `features`; on a
    points shard (`parallel.mesh.PointsShard`) the pool of the whole cloud:
    'add' the local sums summed over the points ranks, 'mean' that over the
    ranks' point counts summed, 'max' the all-reduce max (ties share the
    cotangent evenly, counted over every rank, as `torch.amax`'s do)."""
    if shard is None:
        return GLOBAL_POOLS[kind](features, dim=dim)
    if kind == 'max':
        return shard.max(features, dim)
    total = torch.sum(features, dim=dim)
    return shard.mean(total, features.shape[dim]) if kind == 'mean' else shard.sum(total)


# the chunked sweeps' name of each aggregation
_SWEEP_AGGREGATION = {'max': 'max', 'mean': 'mean', 'add': 'sum'}

# True inside `unfused_eval()`: every EdgeConv call takes `unfused=True`
UNFUSED_EVAL = contextvars.ContextVar('unfused_eval', default=False)


@contextlib.contextmanager
def unfused_eval():
    """Every EdgeConv call inside the block takes `unfused=True`: eval off
    the fused layer, on knn_gather's exact rows (or the kNN route) with the
    f32 edge MLP. Restored on exit, an exception included."""
    token = UNFUSED_EVAL.set(True)
    try:
        yield
    finally:
        UNFUSED_EVAL.reset(token)


class EdgeConv(nn.Module):
    """One dynamic EdgeConv layer: kNN graph on the current features, edge
    MLP on [x_i ; x_j - x_i], then the max, mean or sum (`aggr` 'max',
    'mean', 'add') over the k neighbours.

    Routing, as garment_pattern_estimation_tpu/models/blocks.py:196-284:
      * train, chunked (`train_chunked`, None = when B N k max(C, widths) 4
        bytes pass `_CHUNK_TRAIN_BYTES`): `knn` on the detached input, then
        `ops.edgeconv_train.chunked_edgeconv_train` (`train_chunk_size`
        queries per sweep step, `train_mode` its schedule), then the
        running statistics from its (mean, var) pairs;
      * eval, max, up to 16384 points, C <= 256 and edge-MLP widths up to
        2048 (`fused_edgeconv_supported`): the fused layer `fused_edgeconv`
        (the only aggregation it takes);
      * otherwise, N <= 2048: `knn_gather` (kernels on the card, any C and
        k <= N) and the edge MLP on the slot-major (B, k, N, C) rows;
      * otherwise: `knn` (k <= 128, as the JAX package's), `gather_neighbors`
        and the edge MLP on (B, N, k, C).
    `compute_dtype` (bf16) reaches the MLP, the chunked sweeps, the fused
    layer's `mlp_dtype` (its output stays f32) and knn_gather's one value
    chunk; the kNN runs on the f32 upcast of the input on every path (a
    bf16 input, the previous layer's output, upcasts exactly).

    `forward(x, points_shard)` (a `parallel.mesh.PointsShard`, which the
    encoder passes under a data x points mesh): the input is this rank's
    slice of each cloud's points, and the layer, in train and eval mode
    alike, is the ring (`parallel.ring.ring_knn_gather` with the kernels'
    ranking and knn_gather's rows, `low_precision_rows`), the edge MLP (its
    statistics over the whole mesh, `MLP.data_shard`) and the aggregation
    over the slots, as the JAX package's points-sharded step runs its
    unfused layer. `forward(x, unfused=True)` (a layer on whole clouds
    gathered under such a mesh) keeps eval off the fused layer: the
    knn_gather or kNN route in f32, as the JAX package's points mesh runs
    the XLA layer; train mode routes as without it. Under `unfused_eval()`
    every call takes `unfused=True`: the f32 forward the parity CLI holds
    beside the serving one against the torch reference replica (the fused
    layer truncates its edge MLP's inputs to bf16, as the JAX kernel does).
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
        if aggr not in _SWEEP_AGGREGATION:
            raise ValueError(f'EdgeConv::unsupported aggregation {aggr}')
        if train_mode not in TRAIN_MODES:
            raise ValueError(f'unknown EdgeConv train mode {train_mode!r}')
        self.k = k
        self.aggr = aggr
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

    def forward(self, x, points_shard=None, unfused=False):
        x = x.float().contiguous()
        B, N, C = x.shape
        k = min(self.k, N)
        bf16 = self.compute_dtype == torch.bfloat16
        if points_shard is not None:
            return self._points_sharded(x, points_shard, bf16)
        if self.training and self.chunked(B, N, C):
            idx = knn_search(x.detach(), k)
            out, stats = chunked_edgeconv_train(
                x, idx, self.nn, chunk=self.train_chunk_size,
                aggr=_SWEEP_AGGREGATION[self.aggr], mode=self.train_mode,
                compute_dtype=self.compute_dtype, data_shard=self.nn.data_shard)
            self.nn.update_running_stats(stats)
            return out
        if not self.training and not (unfused or UNFUSED_EVAL.get()) and self.aggr == 'max' \
                and fused_edgeconv_supported(N, C, self.mlp_features):
            return fused_edgeconv(x, self.nn.folded(), k=self.k,
                                  mlp_dtype=torch.bfloat16 if bf16 else torch.float32)
        if knn_gather_supported(N):
            # bf16: the gathered rows and their cotangents in one chunk
            neighbours, _ = knn_gather(x, k, value_chunks=1 if bf16 else 2)
            axis = 1
        else:
            neighbours = gather_neighbors(x, knn_search(x.detach(), k))    # (B, N, k, C)
            axis = 2
        return self._aggregate(self.nn(edge_pair=(x, neighbours, axis)), axis)

    def _aggregate(self, edges, axis):
        if self.aggr == 'max':
            return torch.amax(edges, dim=axis)
        return torch.mean(edges, dim=axis) if self.aggr == 'mean' else torch.sum(edges, dim=axis)

    def _points_sharded(self, x, shard, bf16):
        """The layer on this rank's points (B, S, C) of clouds of P S points."""
        from ..parallel.ring import low_precision_rows, ring_knn_gather

        k = min(self.k, x.shape[1] * shard.size)
        neighbours, _ = ring_knn_gather(x, k, shard.group, ranking='kernel')
        neighbours = low_precision_rows(neighbours, 1 if bf16 else 2)       # (B, S, k, C)
        return self._aggregate(self.nn(edge_pair=(x, neighbours, 2)), 2)


class EdgeConvFeatures(nn.Module):
    """Stacked dynamic EdgeConv layers + optional xyz skip + optional global
    pool and linear head. Returns (global encoding | None, per-point
    features (B, N', F) f32, mask=None); `out_features` is F. `train_chunk_size`
    and `train_mode` reach every layer (`EdgeConv`), and `compute_dtype`
    every layer whose id is not in `f32_conv_layers` (those stay f32).

    `graph_pooling`: layer i (of c = conv_depth) has widths
    int(econv_hidden / (c - i)) and int(econv_feature / (c - i)), and a
    `DynamicGraphPool` (k_neighbors, pool_ratio) follows it, so N' is N
    coarsened once per layer; it cannot be combined with the xyz skip
    (ValueError, as the JAX package raises).

    `points_shard` (None, or the `parallel.mesh.PointsShard` that `Trainer`
    sets under a data x points mesh): the input is this rank's points of
    each cloud. Every layer is then the ring and the global pool sums (or
    takes the maximum) over the points ranks; with graph pooling only the
    first layer is: the first pool gathers its input over the points ranks
    (`PointsShard.gather`), and it, every later layer (`unfused` in eval)
    and pool, and the global pool run on the whole pooled clouds, the same
    on every points rank. `output_shard()` says which the per-point
    features are."""

    def __init__(self, out_size: int, conv_depth: int = 2, k_neighbors: int = 5,
                 econv_hidden: int = 200, econv_hidden_depth: int = 2,
                 econv_feature: int = 112, econv_aggr: str = 'max',
                 global_pool: str = 'mean', skip_connections: bool = False,
                 graph_pooling: bool = False, pool_ratio: float = 0.1,
                 global_head: bool = True, train_chunk_size: int | None = None,
                 train_mode: str = 'fused_final', compute_dtype=None,
                 f32_conv_layers: Sequence[int] = ()):
        super().__init__()
        if graph_pooling and skip_connections:
            raise ValueError(
                'EdgeConvFeatures::graph_pooling coarsens the point set and cannot be '
                'combined with xyz skip connections')
        self.global_pool = global_pool
        self.skip_connections = skip_connections
        if graph_pooling:
            features = [int(econv_feature / c) for c in range(conv_depth, 0, -1)]
            hidden = [int(econv_hidden / c) for c in range(conv_depth, 0, -1)]
        else:
            features, hidden = [econv_feature] * conv_depth, [econv_hidden] * conv_depth
        widths = [3] + features                            # xyz in
        self.conv_layers = nn.ModuleList(
            EdgeConv(widths[i], [hidden[i]] * econv_hidden_depth + [features[i]],
                     k=k_neighbors, aggr=econv_aggr, train_chunk_size=train_chunk_size,
                     train_mode=train_mode,
                     compute_dtype=None if i in tuple(f32_conv_layers) else compute_dtype)
            for i in range(conv_depth))
        self.pool_layers = nn.ModuleList(
            DynamicGraphPool(features[i], k=k_neighbors, pool_ratio=pool_ratio)
            for i in range(conv_depth)) if graph_pooling else None
        self.out_features = widths[-1] + (3 if skip_connections else 0)
        # the global head exists only where the model pools globally
        self.lin = nn.Linear(self.out_features, out_size) if global_head else None
        self.points_shard = None

    def output_shard(self):
        """The points shard of the per-point features: None where they are
        whole clouds (no points mesh, or graph pooling's gather)."""
        return None if self.pool_layers is not None else self.points_shard

    def forward(self, positions, pool_global: bool = True):
        shard = self.points_shard                   # None once the clouds are whole
        out = positions
        for i, conv in enumerate(self.conv_layers):      # k is cut to N inside the layer
            out = conv(out, shard, unfused=self.points_shard is not None)
            if self.pool_layers is not None:
                if shard is not None:
                    out, shard = shard.gather(out), None
                out, _ = self.pool_layers[i](out)
        if self.skip_connections:
            out = torch.cat([out.to(positions.dtype), positions], dim=-1)
        out = out.float()                  # the heads and the loss stay f32
        if pool_global:
            return self.lin(points_pool(self.global_pool, out, shard)), out, None
        return None, out, None


class DynamicGraphPool(nn.Module):
    """Self-attention graph pooling on point features
    (garment_pattern_estimation_tpu/models/blocks.py:370-411): each point's
    kNN cluster (k nearest on the detached features, the standalone kNN
    kernel on the card) is summarized by attention over its neighbours
    (query: the cluster's max), an LEConv-style fitness ranks the clusters,
    and the ceil(pool_ratio N) fittest survive, gated by their fitness.
    Returns (selected (B, keep, C), their point ids (B, keep))."""

    def __init__(self, feature_size: int, k: int = 10, pool_ratio: float = 0.5):
        super().__init__()
        self.k = k
        self.pool_ratio = pool_ratio
        self.att = nn.Linear(2 * feature_size, 1)
        self.fit_self = nn.Linear(feature_size, 1)
        self.fit_nbr = nn.Linear(feature_size, 1)

    def keep(self, n_points):
        """Clusters kept out of n_points: the JAX package's float expression."""
        return max(math.ceil(self.pool_ratio * n_points), 1)

    def forward(self, x):
        x = x.float()
        return self.pool(x, knn_search(x.detach().contiguous(), min(self.k, x.shape[1])))

    def pool(self, x, idx):
        """The pooling on given kNN ids (B, N, k), slot 0 the point itself."""
        cluster, fitness = self.clusters(x, idx)
        # jax.lax.top_k puts the lower index first among equal values, and
        # tanh saturates to exactly +-1 in f32: a stable sort keeps that order
        top_idx = torch.sort(fitness, dim=1, descending=True, stable=True).indices
        top_idx = top_idx[:, :self.keep(x.shape[1])]
        return self.select(cluster, fitness, top_idx), top_idx

    def clusters(self, x, idx):
        """Each point's cluster (B, N, C) and its fitness (B, N)."""
        neighbours = gather_neighbors(x, idx)                         # (B, N, k, C)
        query = torch.amax(neighbours, dim=2)
        att_in = torch.cat([query[:, :, None, :].expand_as(neighbours), neighbours], dim=-1)
        weights = torch.softmax(F.leaky_relu(self.att(att_in)[..., 0], 0.01), dim=-1)
        cluster = torch.einsum('bnk,bnkc->bnc', weights, neighbours)
        fitness = torch.tanh(
            self.fit_self(cluster)[..., 0]
            + self.fit_nbr(cluster - torch.mean(gather_neighbors(cluster, idx), dim=2))[..., 0])
        return cluster, fitness

    @staticmethod
    def select(cluster, fitness, top_idx):
        """The clusters of `top_idx` (B, keep), gated by their fitness."""
        selected = cluster.gather(1, top_idx[..., None].expand(-1, -1, cluster.shape[-1]))
        return selected * fitness.gather(1, top_idx)[..., None]


class EdgeConvPoolingFeatures(nn.Module):
    """Three EdgeConv layers with a `DynamicGraphPool` after the first two,
    a max pool and a linear head
    (garment_pattern_estimation_tpu/models/blocks.py:414-444): widths
    64-64-n1, n2 x 3, n3 x 3, k cut to each stage's point count. Always
    returns the global encoding beside the per-point features (B, N'', n3).
    Under a points mesh (`points_shard`) conv1 is the ring and pool1
    gathers its input: the rest runs on whole clouds (see
    `EdgeConvFeatures`)."""

    def __init__(self, out_size: int, n_features1: int = 32, n_features2: int = 128,
                 n_features3: int = 256, k: int = 10, pool_ratio: float = 0.5):
        super().__init__()
        self.conv1 = EdgeConv(3, [64, 64, n_features1], k=k)
        self.pool1 = DynamicGraphPool(n_features1, k=k, pool_ratio=pool_ratio)
        self.conv2 = EdgeConv(n_features1, [n_features2] * 3, k=k)
        self.pool2 = DynamicGraphPool(n_features2, k=k, pool_ratio=pool_ratio)
        self.conv3 = EdgeConv(n_features2, [n_features3] * 3, k=k)
        self.lin = nn.Linear(n_features3, out_size)
        self.out_features = n_features3
        self.points_shard = None

    def output_shard(self):
        """None: the per-point features are whole clouds."""
        return None

    def forward(self, positions, pool_global: bool = True):
        shard = self.points_shard
        out = self.conv1(positions, shard)
        if shard is not None:
            out = shard.gather(out)
        unfused = shard is not None
        out, _ = self.pool1(out)
        out, _ = self.pool2(self.conv2(out, unfused=unfused))
        out = self.conv3(out, unfused=unfused)
        return self.lin(torch.amax(out, dim=1)), out, None


def farthest_point_sampling(positions, num_samples):
    """FPS ids (B, M) int64 over (B, N, 3), from point 0, the first maximum
    on ties (garment_pattern_estimation_tpu/models/blocks.py:451-469): M - 1
    steps of plain PyTorch with no host sync."""
    positions = positions.detach()
    B, N, _ = positions.shape
    idx = torch.zeros(B, num_samples, dtype=torch.int64, device=positions.device)
    dists = torch.full((B, N), math.inf, device=positions.device)
    for i in range(1, num_samples):
        last = positions.gather(1, idx[:, i - 1, None, None].expand(B, 1, 3))
        dists = torch.minimum(dists, torch.sum((positions - last) ** 2, dim=-1))
        idx[:, i] = torch.argmax(dists, dim=1)
    return idx


class SetAbstraction(nn.Module):
    """FPS centroids, radius neighbourhoods capped at the `max_neighbors`
    nearest, a shared MLP on each neighbour's [features ; relative position]
    and a max over the valid ones (garment_pattern_estimation_tpu/models/
    blocks.py:472-509). The MLP runs on every gathered row, out-of-radius
    ones included, so they enter its batch statistics as in JAX.

    With `points_shard` (the input is this rank's points of each cloud):
    the positions (and features) are gathered over the points ranks, FPS
    runs on the whole clouds, the same on every rank, and this rank keeps
    its share of the centroids in order (`PointsShard.span`, uneven where
    the ranks do not divide M), ball-queries them against the whole
    clouds and runs the MLP, the largest tensor, on its rows (its
    statistics weighed by its rows, `DataShard.mean`)."""

    def __init__(self, in_features: int, mlp_features: Sequence[int], ratio: float = 0.2,
                 radius: float = 0.3, max_neighbors: int = 25):
        super().__init__()
        self.ratio = ratio
        self.radius = radius
        self.max_neighbors = max_neighbors
        self.mlp = MLP([in_features + 3, *mlp_features])

    def centroids(self, n_points):
        """The centroid count M of a cloud of `n_points`."""
        return max(int(self.ratio * n_points), 1)

    def forward(self, features, positions, points_shard=None):
        if points_shard is not None:
            positions = points_shard.gather(positions.detach())
            if features is not None:
                features = points_shard.gather(features)
        B, N, _ = positions.shape
        M = self.centroids(N)
        centroids = positions.gather(
            1, farthest_point_sampling(positions, M)[..., None].expand(B, M, 3))
        if points_shard is not None:
            start, stop = points_shard.span(M)
            if start == stop:
                raise ValueError(f'SetAbstraction: {M} centroids leave points rank '
                                 f'{points_shard.rank} of {points_shard.size} none')
            centroids, M = centroids[:, start:stop], stop - start
        d = pairwise_sq_dists(centroids, positions)                  # (B, M, N)
        capped = torch.where(d <= self.radius ** 2, d, math.inf)
        # the nearest inside the radius, lower id first on ties (the
        # out-of-radius infinities tie too, and decide which rows enter BN)
        top, nbr_idx = torch.sort(capped, dim=-1, stable=True)
        K = min(self.max_neighbors, N)
        valid = torch.isfinite(top[..., :K])                         # (B, M, K)
        nbr_idx = nbr_idx[..., :K]
        local = gather_neighbors(positions, nbr_idx) - centroids[:, :, None, :]
        if features is not None:
            local = torch.cat([gather_neighbors(features, nbr_idx), local], dim=-1)
        h = self.mlp(local.reshape(-1, local.shape[-1])).reshape(B, M, K, -1)
        pooled = torch.amax(torch.where(valid[..., None], h, -math.inf), dim=2)
        return torch.where(torch.isfinite(pooled), pooled, 0.0), centroids


class PointNetPlusPlus(nn.Module):
    """One set abstraction (ratio 0.2, radius r1, 25 neighbours, MLP
    hidden-hidden-feature), then a per-point MLP on [features ; centroid],
    a max pool and a linear head
    (garment_pattern_estimation_tpu/models/blocks.py:512-537). Always
    returns the global encoding beside the per-centroid features. Under a
    points mesh (`points_shard`) the features are this rank's centroids'
    (`SetAbstraction`), and the max pool is over every rank's."""

    def __init__(self, out_size: int, econv_hidden: int = 200, econv_feature: int = 150,
                 r1: float = 0.3):
        super().__init__()
        widths = [econv_hidden, econv_hidden, econv_feature]
        self.sa1 = SetAbstraction(0, widths, ratio=0.2, radius=r1)
        self.mlp = MLP([econv_feature + 3, *widths])
        self.lin = nn.Linear(econv_feature, out_size)
        self.out_features = econv_feature
        self.points_shard = None

    def output_shard(self):
        """The points shard of the per-centroid features (None: whole)."""
        return self.points_shard

    def forward(self, positions, pool_global: bool = True):
        positions = positions.float()
        h, centroids = self.sa1(None, positions, self.points_shard)
        local = torch.cat([h, centroids], dim=-1)
        g = self.mlp(local.reshape(-1, local.shape[-1])).reshape(*local.shape[:2], -1)
        return self.lin(points_pool('max', g, self.points_shard)), g, None


def inverted_dropout(x, rate, generator=None, shard=None):
    """flax's `nn.Dropout(rate)` in train mode: each element kept with
    probability 1 - rate and scaled by 1 / (1 - rate), else zero. The mask
    is drawn from `generator` (torch's default generator without one); with
    a `parallel.DataShard`, for the global batch, of which x holds this
    rank's rows."""
    device = x.device if generator is None else generator.device
    shape = x.shape if shard is None else (x.shape[0] * shard.size, *x.shape[1:])
    keep = torch.rand(shape, generator=generator, device=device)
    if shard is not None:
        keep = shard.rows(keep)
    keep = keep.to(x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class _RNN(nn.Module):
    """The parameters of a multi-layer nn.LSTM / nn.GRU, their names and
    layout: per layer `weight_ih_l{k}` (gates H, in), `weight_hh_l{k}`
    (gates H, H), `bias_ih_l{k}`, `bias_hh_l{k}` (gates H)."""

    GATES = 1

    def __init__(self, input_size: int, hidden_size: int, n_layers: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        rows = self.GATES * hidden_size
        for layer in range(n_layers):
            fan_in = input_size if layer == 0 else hidden_size
            self.register_parameter(f'weight_ih_l{layer}',
                                    nn.Parameter(torch.empty(rows, fan_in)))
            self.register_parameter(f'weight_hh_l{layer}',
                                    nn.Parameter(torch.empty(rows, hidden_size)))
            self.register_parameter(f'bias_ih_l{layer}', nn.Parameter(torch.empty(rows)))
            self.register_parameter(f'bias_hh_l{layer}', nn.Parameter(torch.empty(rows)))


class TorchLSTM(_RNN):
    """Multi-layer LSTM over (B, T, C) with nn.LSTM's parameter names,
    layout and gate order (i, f, g, o), unrolled as an explicit cell loop
    like the JAX scan."""

    GATES = 4

    def forward(self, inputs, init_states, dropout=0.0, generator=None, shard=None):
        """inputs (B, T, C); init_states: [(h0, c0)] per layer. Returns
        (outputs (B, T, H), [(h, c)] final states per layer). `dropout` > 0
        drops that share of each layer's output but the last's
        (`inverted_dropout`, masks from `generator`, for the global batch
        under a `shard`)."""
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
                x = inverted_dropout(x, dropout, generator, shard)
        return x, final_states


class TorchGRU(_RNN):
    """Multi-layer GRU over (B, T, C) with nn.GRU's parameter names, layout
    and gate order (r, z, n), h' = (1 - z) n + z h, unrolled as an explicit
    cell loop like the JAX scan (garment_pattern_estimation_tpu/models/
    blocks.py:589-623); no dropout, as there."""

    GATES = 3

    def forward(self, inputs, init_states):
        """inputs (B, T, C); init_states: h0 per layer. Returns the outputs
        (B, T, H) of the last layer."""
        x = inputs
        for layer in range(self.n_layers):
            w_hh = getattr(self, f'weight_hh_l{layer}')
            b_hh = getattr(self, f'bias_hh_l{layer}')
            gates_x = x @ getattr(self, f'weight_ih_l{layer}').t() \
                + getattr(self, f'bias_ih_l{layer}')
            h = init_states[layer]
            outs = []
            for step in range(x.shape[1]):
                xr, xz, xn = gates_x[:, step].chunk(3, dim=-1)
                hr, hz, hn = (h @ w_hh.t() + b_hh).chunk(3, dim=-1)
                r = torch.sigmoid(xr + hr)
                z = torch.sigmoid(xz + hz)
                n = torch.tanh(xn + r * hn)
                h = (1 - z) * n + z * h
                outs.append(h)
            x = torch.stack(outs, dim=1)
        return x


class _Recurrent(nn.Module):
    """The recurrent decoders' and the LSTM encoder's shared part: their
    sizes, `dropout` between LSTM layers in train mode (`inverted_dropout`)
    and the initial states. With 'kaiming_normal' in `state_init` and a
    `generator` from the caller, fresh normal states of std
    sqrt(2 / (batch * hidden)) on every forward, in train and eval mode
    alike (the reference's noise, drawn h then c per layer, as the JAX
    package's `_init_states` draws whenever it has the 'recurrent_init'
    rng); zeros without a generator (serving). Under a `data_shard` (set by
    `Trainer` under a data mesh) the states and dropout masks are drawn for
    the global batch, std included, and this rank keeps its rows."""

    def __init__(self, hidden_size: int, n_layers: int, out_len: int | None = None,
                 dropout: float = 0.0, state_init: str = 'kaiming_normal'):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.out_len = out_len
        self.dropout = float(dropout or 0)
        self.state_init = state_init or ''
        self.data_shard = None

    def initial_states(self, batch_size, device, generator=None, with_cell=True):
        """[(h0, c0)] per layer, or [h0] per layer without `with_cell`;
        (batch_size, hidden) each."""
        if generator is not None and 'kaiming_normal' in self.state_init:
            shard = self.data_shard
            rows = batch_size * (1 if shard is None else shard.size)
            std = math.sqrt(2.0 / (rows * self.hidden_size))

            def draw():
                drawn = torch.randn(rows, self.hidden_size, generator=generator,
                                    device=generator.device) * std
                return (drawn if shard is None else shard.rows(drawn)).to(device)
        else:
            zeros = torch.zeros(batch_size, self.hidden_size, device=device)

            def draw():
                return zeros
        return [(draw(), draw()) if with_cell else draw() for _ in range(self.n_layers)]

    def repeated(self, encodings, out_len=None):
        """The decoder input: each encoding repeated out_len (default the
        module's) times, (B, T, E)."""
        B, E = encodings.shape
        return encodings[:, None, :].expand(B, out_len or self.out_len, E)

    def train_dropout(self):
        return self.dropout if self.training else 0.0


class LSTMDecoderModule(_Recurrent):
    """Encoding -> sequence: the encoding repeated `out_len` times feeds the
    LSTM, a linear head maps hidden states to elements. In train mode
    `dropout` acts between the LSTM layers, as in the JAX package's
    `TorchLSTM`. Initial states: `_Recurrent`."""

    def __init__(self, encoding_size: int, hidden_size: int, out_elem_size: int,
                 n_layers: int, out_len: int, dropout: float = 0.0,
                 state_init: str = 'kaiming_normal'):
        super().__init__(hidden_size, n_layers, out_len, dropout, state_init)
        self.lstm = TorchLSTM(encoding_size, hidden_size, n_layers)
        self.lin = nn.Linear(hidden_size, out_elem_size)

    def forward(self, encodings, out_len=None, generator=None):
        """`generator` also draws the train-mode dropout masks between the
        LSTM layers, after the initial states."""
        out, _ = self.lstm(self.repeated(encodings, out_len),
                           self.initial_states(encodings.shape[0], encodings.device, generator),
                           dropout=self.train_dropout(), generator=generator,
                           shard=self.data_shard)
        return self.lin(out)


class LSTMDoubleReverseDecoderModule(_Recurrent):
    """A decode in reverse order, flipped and concatenated with the decoder
    input, then a forward LSTM that starts from the reverse pass's final
    states (garment_pattern_estimation_tpu/models/blocks.py:682-706).
    Initial states: `_Recurrent`, for the reverse pass; dropout masks: the
    reverse pass's, then the forward pass's."""

    def __init__(self, encoding_size: int, hidden_size: int, out_elem_size: int,
                 n_layers: int, out_len: int, dropout: float = 0.0,
                 state_init: str = 'kaiming_normal'):
        super().__init__(hidden_size, n_layers, out_len, dropout, state_init)
        self.lstm_reverse = TorchLSTM(encoding_size, hidden_size, n_layers)
        self.lstm_forward = TorchLSTM(hidden_size + encoding_size, hidden_size, n_layers)
        self.lin = nn.Linear(hidden_size, out_elem_size)

    def forward(self, encodings, out_len=None, generator=None):
        dec_input = self.repeated(encodings, out_len)
        out, final_states = self.lstm_reverse(
            dec_input, self.initial_states(encodings.shape[0], encodings.device, generator),
            dropout=self.train_dropout(), generator=generator, shard=self.data_shard)
        out, _ = self.lstm_forward(torch.cat([out.flip(1), dec_input], dim=-1), final_states,
                                   dropout=self.train_dropout(), generator=generator,
                                   shard=self.data_shard)
        return self.lin(out)


class GRUDecoderModule(_Recurrent):
    """The GRU variant of the sequence decoder
    (garment_pattern_estimation_tpu/models/blocks.py:709-728): its cell is
    `recurrent_cell`, the reference's name; initial states h only
    (`_Recurrent`); `dropout` is not used, as in JAX."""

    def __init__(self, encoding_size: int, hidden_size: int, out_elem_size: int,
                 n_layers: int, out_len: int, dropout: float = 0.0,
                 state_init: str = 'kaiming_normal'):
        super().__init__(hidden_size, n_layers, out_len, 0.0, state_init)
        self.recurrent_cell = TorchGRU(encoding_size, hidden_size, n_layers)
        self.lin = nn.Linear(hidden_size, out_elem_size)

    def forward(self, encodings, out_len=None, generator=None):
        states = self.initial_states(encodings.shape[0], encodings.device, generator,
                                     with_cell=False)
        return self.lin(self.recurrent_cell(self.repeated(encodings, out_len), states))


class LSTMEncoderModule(_Recurrent):
    """Sequence (B, T, input_size) -> encoding: the last layer's final
    hidden state (garment_pattern_estimation_tpu/models/blocks.py:731-745,
    whose input width flax infers; no model uses it)."""

    def __init__(self, input_size: int, encoding_size: int, n_layers: int,
                 dropout: float = 0.0, state_init: str = 'kaiming_normal'):
        super().__init__(encoding_size, n_layers, None, dropout, state_init)
        self.lstm = TorchLSTM(input_size, encoding_size, n_layers)

    def forward(self, sequences, generator=None):
        _, final_states = self.lstm(
            sequences, self.initial_states(sequences.shape[0], sequences.device, generator),
            dropout=self.train_dropout(), generator=generator, shard=self.data_shard)
        return final_states[-1][0]


class MLPDecoder(nn.Module):
    """Encoding -> fixed-length sequence through one MLP (Linear -> ReLU ->
    BatchNorm, every layer) of widths [hidden_size out_len] x n_layers +
    [out_elem_size out_len], reshaped to (B, out_len, out_elem_size)
    (garment_pattern_estimation_tpu/models/blocks.py:748-765). `dropout`
    and `state_init` are not used, as in JAX."""

    def __init__(self, encoding_size: int, hidden_size: int, out_elem_size: int,
                 n_layers: int, out_len: int, dropout: float = 0.0, state_init: str = ''):
        super().__init__()
        self.out_len = out_len
        self.mlp = MLP([encoding_size] + [hidden_size * out_len] * n_layers
                       + [out_elem_size * out_len])

    def forward(self, encodings, out_len=None, generator=None):
        """`generator` is not used: it is taken so that the models call
        every decoder the same way."""
        if out_len not in (None, self.out_len):
            raise ValueError(f'MLPDecoder: built for out_len {self.out_len}, got {out_len}')
        return self.mlp(encodings).reshape(encodings.shape[0], self.out_len, -1)


DECODER_REGISTRY = {
    'LSTMDecoderModule': LSTMDecoderModule,
    'LSTMDoubleReverseDecoderModule': LSTMDoubleReverseDecoderModule,
    'GRUDecoderModule': GRUDecoderModule,
    'MLPDecoder': MLPDecoder,
}

ENCODER_REGISTRY = {
    'EdgeConvFeatures': EdgeConvFeatures,
    'PointNetPlusPlus': PointNetPlusPlus,
    'EdgeConvPoolingFeatures': EdgeConvPoolingFeatures,
}
