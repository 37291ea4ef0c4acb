"""Memory-bounded training path of dynamic EdgeConv: chunked over queries,
rematerialized, differentiable. The (B, N, k, C) gathered neighbours and
the (B, N, k, H) edge-MLP intermediates never exist whole.

Training needs BatchNorm statistics over every edge row, which couple the
chunks, and gradients. The layer runs as sweeps over query chunks (edge
MLP on [x_i ; x_j - x_i], Linear -> ReLU -> BN per layer):

  sweep l (l = 0..L-1): recompute layers 0..l-1 per chunk with the
      statistics already known, sum relu(z_l) and its square over the
      valid rows -> (mean_l, var_l);
  final: every layer with the global statistics, then the aggregation over
      the k neighbour slots.

Each sweep body over a chunk runs under
`torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`: the forward
keeps only the per-chunk outputs and the O(C) statistic partials, the
backward recomputes the chunk's intermediates. The statistics are
differentiable functions of the weights and the input, so the backward
carries the whole training-mode BatchNorm coupling with no hand-written
gradient. Nothing here is a kernel: the gather, the matmuls and the sums are
plain PyTorch, as in the JAX package.

`compute_dtype=bfloat16` runs the products and ReLUs in bf16 (tensor
cores on the card): the edge input and each layer's W and b are cast to
bf16, and so is each BatchNorm's f32 output before the next product; the
statistics and the BatchNorm normalization stay f32.

Counterpart of garment_pattern_estimation_tpu/ops/edgeconv_train.py
(`chunked_edgeconv_train`, where `jax.checkpoint` inside `lax.scan` plays
the part of the checkpointed loop here; the bf16 mode is its `dtype` in
`_apply_layers`, :66-105, and `cdtype`, :146).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_compute_dtype
from .pooling import gather_neighbors

MODES = ('chunked', 'fused_final', 'streamed')
AGGREGATIONS = ('max', 'mean', 'sum')


def _default_chunk(B, N, k, widest):
    """Queries per sweep step: the widest per-edge tensor (the gathered C or
    any hidden width; the 2C edge concat never materializes) near 1 GB."""
    per_row = B * k * widest * 4
    return max(32, min(N, (1 << 30) // max(per_row, 1)))


def _layer_params(mlp):
    """[(W (in, out), b, gamma, beta)] per layer of the port's `MLP`."""
    return [(linear.weight.t(), linear.bias, bn.weight, bn.bias)
            for linear, _, bn in mlp]


def _apply_layers(edge_pair, layers, stats, upto, eps, final_relu_only=False,
                  dtype=None):
    """Layers [0, upto) on the factored edge input: Linear -> ReLU -> BN
    with the given global statistics; with `final_relu_only`, layer upto-1
    stops after its ReLU.

    `edge_pair` is (center (B, c, C), neighbours (B, c, k, C)): layer 0
    computes concat(c, n - c) @ W = c @ (W_top - W_bot) + b + n @ W_bot,
    so the (B, c, k, 2C) edge tensor never materializes. `dtype` (bf16)
    casts the edge input, each W and b, and each later layer's input to it:
    products and ReLUs in bf16, the BN normalization in f32."""
    center, nbr = edge_pair
    if dtype is not None:
        center, nbr = center.to(dtype), nbr.to(dtype)
    h = None
    for l in range(upto):
        W, b, gamma, beta = layers[l]
        if dtype is not None:
            W, b = W.to(dtype), b.to(dtype)
        if l == 0:
            C = center.shape[-1]
            point_term = center @ (W[:C] - W[C:]) + b              # (B, c, H)
            h = torch.relu(point_term[:, :, None, :] + nbr @ W[C:])
        else:
            if dtype is not None:
                h = h.to(dtype)
            h = torch.relu(h @ W + b)
        if final_relu_only and l == upto - 1:
            return h
        mean, var = stats[l]
        h = (h.float() - mean) * torch.rsqrt(var + eps) * gamma + beta
    return h


def _aggregate(a, aggr):
    """Over the k slots: max, mean or sum."""
    if aggr == 'max':
        return torch.amax(a, dim=2)
    if aggr == 'mean':
        return torch.mean(a, dim=2)
    return torch.sum(a, dim=2)


def chunked_edgeconv_train(x, idx, mlp, *, eps=1e-5, chunk=None, aggr='max',
                           mode='chunked', compute_dtype=None, data_shard=None):
    """EdgeConv training forward with global BatchNorm batch statistics in
    O(B * chunk * k * C) memory.

    x (B, N, C) f32; idx (B, N, k) neighbour ids, slot 0 = self; `mlp` the
    layer's `models.blocks.MLP`; `chunk` queries per sweep step (None: the
    ~1 GB rule of `_default_chunk`); `aggr` 'max', 'mean' or 'sum' over the
    k slots. `mode` chooses the sweep schedule, all with the same math:
      * 'chunked': L statistics sweeps and a final sweep;
      * 'fused_final': the last statistics sweep also emits each chunk's
        max and min (or mean, or sum) of the last pre-BN activations, and
        the last BN, a per-channel affine a * h + c, is applied after the
        aggregation (max_k(a h + c) is a max_k(h) + c where a > 0 and
        a min_k(h) + c where a < 0);
      * 'streamed': 'fused_final', and the sweep of layer L-2 keeps its
        post-ReLU chunks, so the last sweep reads them instead of
        recomputing layers 0..L-2 (one (B, N, k, H) buffer more).
    Padded query rows of the last chunk gather real rows, are left out of
    the statistics and are sliced off. `compute_dtype` (None, 'float32',
    'bfloat16' or a torch dtype): bf16 runs the products and ReLUs in bf16,
    the statistics and normalizations in f32; 'fused_final' aggregates the
    bf16 activations and 'streamed' keeps them in bf16, as the JAX sweeps do.
    `data_shard` (a `parallel.DataShard`, under a data mesh): each layer's
    moments are the means over the mesh's ranks of every rank's, those of
    the global batch (each rank holds as many rows).

    Returns (out (B, N, F), [(mean_l, var_l)] per layer), both
    differentiable; the variances are biased, E[a^2] - E[a]^2 clamped at 0.
    """
    cdtype = resolve_compute_dtype(compute_dtype)
    if mode not in MODES:
        raise ValueError(f'unknown EdgeConv train mode {mode!r}')
    if aggr not in AGGREGATIONS:
        raise ValueError(f'unknown EdgeConv aggregation {aggr!r}')
    B, N, C = x.shape
    k = idx.shape[-1]
    layers = _layer_params(mlp)
    L = len(layers)
    if chunk is None:
        chunk = _default_chunk(B, N, k, max([C] + [W.shape[1] for W, *_ in layers]))
    chunk = min(chunk, N)
    pad = (-N) % chunk
    # padded query rows gather row 0 of their cloud and are masked out
    x_q = torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x
    idx = torch.nn.functional.pad(idx, (0, 0, 0, pad)) if pad else idx
    starts = range(0, N + pad, chunk)

    def edges_at(start):
        return x_q[:, start:start + chunk], gather_neighbors(x, idx[:, start:start + chunk])

    fuse = mode in ('fused_final', 'streamed')
    buf_layer = L - 2 if (mode == 'streamed' and L >= 2) else None
    count = B * N * k
    stats = []
    h_buf = None         # streamed: post-ReLU chunks of layer L-2
    final_agg = None     # fused: per-chunk aggregates of the last pre-BN activations
    for l in range(L):
        produce_buf = l == buf_layer
        is_final = fuse and l == L - 1
        reads_buf = buf_layer is not None and l == L - 1

        def sweep_body(start, h_prev=None, _l=l, _final=is_final, _produce=produce_buf):
            if h_prev is not None:
                # streamed last sweep: BN_{L-2} of the stored chunk -> layer L-1
                gp, bp = layers[buf_layer][2], layers[buf_layer][3]
                m, v = stats[buf_layer]
                h = (h_prev.float() - m) * torch.rsqrt(v + eps) * gp + bp
                W, b = layers[_l][0], layers[_l][1]
                if cdtype is not None:
                    h, W, b = h.to(cdtype), W.to(cdtype), b.to(cdtype)
                a = torch.relu(h @ W + b)
            else:
                a = _apply_layers(edges_at(start), layers, stats, _l + 1, eps,
                                  final_relu_only=True, dtype=cdtype)
            valid = a[:, :N - start].float()          # the chunk's rows below N
            s1 = torch.sum(valid, dim=(0, 1, 2))
            s2 = torch.sum(valid * valid, dim=(0, 1, 2))
            if _final:
                return s1, s2, (_aggregate(a, aggr), torch.amin(a, dim=2)) \
                    if aggr == 'max' else _aggregate(a, aggr)
            return (s1, s2, a) if _produce else (s1, s2)

        s1 = s2 = None
        ys = []
        for i, start in enumerate(starts):
            args = (start, h_buf[i]) if reads_buf else (start,)
            res = checkpoint(sweep_body, *args, use_reentrant=False,
                             preserve_rng_state=False)
            s1 = res[0] if s1 is None else s1 + res[0]
            s2 = res[1] if s2 is None else s2 + res[1]
            if len(res) == 3:
                ys.append(res[2])
        mean, sq = s1 / count, s2 / count
        if data_shard is not None:
            mean, sq = data_shard.mean(torch.stack([mean, sq]))
        stats.append((mean, torch.clamp_min(sq - mean * mean, 0.0)))
        if is_final:
            final_agg = ys
        elif produce_buf:
            h_buf = ys

    if fuse:
        gamma, beta = layers[-1][2], layers[-1][3]
        m, v = stats[-1]
        a_aff = gamma * torch.rsqrt(v + eps)
        c_aff = beta - m * a_aff
        if aggr == 'max':
            mx = torch.cat([y[0] for y in final_agg], dim=1).float()
            mn = torch.cat([y[1] for y in final_agg], dim=1).float()
            out = torch.where(a_aff > 0, mx * a_aff + c_aff, mn * a_aff + c_aff)
        elif aggr == 'mean':
            out = torch.cat(final_agg, dim=1).float() * a_aff + c_aff
        else:   # sum: the affine constant adds once per neighbour slot
            out = torch.cat(final_agg, dim=1).float() * a_aff + k * c_aff
        return out[:, :N], stats

    def out_body(start):
        return _aggregate(_apply_layers(edges_at(start), layers, stats, L, eps,
                                        dtype=cdtype), aggr)

    outs = [checkpoint(out_body, start, use_reentrant=False, preserve_rng_state=False)
            for start in starts]
    return torch.cat(outs, dim=1)[:, :N], stats
