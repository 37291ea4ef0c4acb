"""Ring kNN + neighbour gather over a points-sharded cloud, and the
points-sharded dynamic EdgeConv built on it.

Counterpart of garment_pattern_estimation_tpu/parallel/ring.py, which is
plain XLA with no Pallas: here it is plain PyTorch. Each rank of a group
holds a contiguous (B, S, C) shard of a (B, P S, C) cloud (rank p: global
rows [p S, (p + 1) S)), which is also its first key shard; key shards travel
the ring (`collectives.ring_shift`). At each of the P steps a rank ranks the
visiting keys against its queries and merges their k - 1 best candidates,
with their rows, into its running list (`_ring_merge`). After P steps every
query holds its exact global neighbourhood and no rank has held the whole
cloud.

The selection is the port's kernels' (PARITY.md #5, #7): each distance is
ranked by the top 21 bits of its f32 value (`_quantized`), ties go to the
lower global index, and slot 0 is the query itself. The distance is
`ops.knn.pairwise_sq_dists` (the JAX ring's formula, TF32 off) by default;
`ranking='kernel'` takes the fused layer's and knn_gather's (one function,
`ops.edgeconv.edgeconv_sq_dists`: exact per dimension up to 16 features,
the 2-term split products beyond), so a points-sharded layer picks the
neighbours the one-process layer's plain version picks, and
`low_precision_rows` gathers their rows as knn_gather does.

The hand-written kNN kernels do not fit a ring step: they rank a cloud
against itself, while a ring step ranks a query shard against another
rank's keys. `_ring_merge` takes the keys and the shard they came from as
arguments, so one process can drive the merge over P shards on one card by
feeding them in ring order.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..ops.edgeconv import edgeconv_sq_dists, gathered_rows
from ..ops.knn import IDX_MASK, INT_MAX, pairwise_sq_dists, truncate_bf16
from ..ops.pooling import gather_neighbors
from .collectives import all_reduce_sum, ring_shift
from .mesh import POINTS_AXIS, _axis, _device_type, _whole_world


def _quantized(dists):
    """Distances as int32 in the kernels' 21-bit ranking class
    (non-negative f32 bits order as their int32 pattern)."""
    return torch.clamp_min(dists, 0.0).view(torch.int32) & ~IDX_MASK


_RANKINGS = {'norm': pairwise_sq_dists, 'kernel': edgeconv_sq_dists}


class _LowPrecisionRows(torch.autograd.Function):
    """knn_gather's rows of slots >= 1 (`ops.edgeconv.gathered_rows`); the
    cotangent passes at full f32 (value_chunks 2) or truncated to bf16 (1),
    as knn_gather's backward adds it."""

    @staticmethod
    def forward(ctx, rows, value_chunks):
        ctx.value_chunks = value_chunks
        out = gathered_rows(rows, value_chunks)
        return out.clone() if out is rows else out

    @staticmethod
    def backward(ctx, g):
        return (truncate_bf16(g) if ctx.value_chunks == 1 else g), None


def low_precision_rows(nbr, value_chunks):
    """Neighbours (B, S, k, C) with slots >= 1 as knn_gather gathers them."""
    return torch.cat([nbr[:, :, :1], _LowPrecisionRows.apply(nbr[:, :, 1:], value_chunks)],
                     dim=2)


def _topk_with_values(qd, idx, vals, k):
    """The k smallest (quantized distance, global index) pairs along the
    last axis of qd and idx, ties to the lower index, and their rows of
    vals (..., candidates, C). Returns (qd, idx, vals)."""
    key = (qd.to(torch.int64) << 32) | idx.to(torch.int64)
    key, pos = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    vals = torch.gather(vals, -2, pos[..., None].expand(*pos.shape, vals.shape[-1]))
    return (key >> 32).to(torch.int32), key & 0xFFFFFFFF, vals


def _ring_init(x_local, k, shards):
    """The empty running list of a query shard: (qd, global ids, rows) with
    min(k, P S) - 1 places."""
    B, S, C = x_local.shape
    km1 = min(k, shards * S) - 1
    return (torch.full((B, S, km1), INT_MAX, dtype=torch.int32, device=x_local.device),
            torch.zeros(B, S, km1, dtype=torch.int64, device=x_local.device),
            x_local.new_zeros(B, S, km1, C))


def _ring_merge(x_local, keys, src, acc, me, ranking='norm'):
    """One ring step: the keys (B, S, C) of shard `src` ranked against the
    queries of shard `me` by the `ranking`'s distances, their best
    candidates merged into the running list `acc` (`_ring_init`). Returns
    the new list."""
    acc_qd, acc_i, acc_v = acc
    B, S, C = x_local.shape
    km1 = acc_qd.shape[-1]
    ar = torch.arange(S, device=x_local.device)
    row, col = me * S + ar, src * S + ar
    with torch.no_grad():
        dists = _RANKINGS[ranking](x_local.detach(), keys.detach())
    qd = torch.where(col[None, None, :] == row[None, :, None], INT_MAX,
                     _quantized(dists))                                      # self -> slot 0
    key = (qd.to(torch.int64) << 32) | col
    key, pos = torch.topk(key, min(km1, S), dim=-1, largest=False, sorted=True)
    return _topk_with_values(torch.cat([acc_qd, (key >> 32).to(torch.int32)], dim=-1),
                             torch.cat([acc_i, key & 0xFFFFFFFF], dim=-1),
                             torch.cat([acc_v, gather_neighbors(keys, pos)], dim=-2), km1)


def _ring_output(x_local, acc, me):
    """(neighbours (B, S, k, C), global ids (B, S, k)): the query first."""
    _, acc_i, acc_v = acc
    B, S, _ = x_local.shape
    row = me * S + torch.arange(S, device=x_local.device)
    return (torch.cat([x_local[:, :, None, :], acc_v], dim=2),
            torch.cat([row[None, :, None].expand(B, S, 1), acc_i], dim=-1))


def ring_knn_gather(x_local, k, group=None, ranking='norm'):
    """Global kNN + neighbour rows of a points-sharded cloud.

    x_local (B, S, C): this rank's shard of a (B, P S, C) cloud sharded
    contiguously over the P ranks of `group` (None: the default group).
    Returns neighbours (B, S, k, C), slot 0 the query itself, and their
    global ids (B, S, k) int64, for this rank's queries, ranked by the
    distances of `ranking` ('norm' or 'kernel', see above). Differentiable
    in the gathered rows (through the ring's backward)."""
    shards, me = dist.get_world_size(group), dist.get_rank(group)
    acc = _ring_init(x_local, k, shards)
    keys = x_local
    for step in range(shards):
        acc = _ring_merge(x_local, keys, (me - step) % shards, acc, me, ranking)
        if step + 1 < shards:
            keys = ring_shift(keys, group)
    return _ring_output(x_local, acc, me)


def ring_edgeconv(x_local, mlp_apply, k, group=None, aggr='max'):
    """One points-sharded dynamic EdgeConv layer: the ring kNN + gather, the
    edge MLP `mlp_apply` ((..., 2C) -> (..., F), e.g. the port's `MLP` in
    eval) on [x_i ; x_j - x_i] and the max, mean or sum over the k slots.
    The output stays sharded like the input."""
    nbr, _ = ring_knn_gather(x_local, k, group)
    center = x_local[:, :, None, :].expand_as(nbr)
    out = mlp_apply(torch.cat([center, nbr - center], dim=-1))
    if aggr == 'max':
        return torch.amax(out, dim=2)
    if aggr == 'mean':
        return torch.mean(out, dim=2)
    if aggr == 'add':
        return torch.sum(out, dim=2)
    raise ValueError(f'ring_edgeconv: unsupported aggregation {aggr}')


def make_points_mesh(n=None):
    """1-D mesh ('points',) over the world (`n`, if given, must be the
    world size)."""
    n = dist.get_world_size() if n is None else int(n)
    _whole_world(n, 'make_points_mesh')
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(POINTS_AXIS,))


def sharded_encoder_step(mesh, mlps, x, k, aggrs=None, data_axis=None):
    """A stack of points-sharded dynamic EdgeConv layers over `mesh` (a mesh
    with a 'points' axis; on a 2-D mesh `data_axis` names its batch axis).

    `x` (B, N, C) is the whole cloud batch, the same on every rank; this
    rank takes its rows (data axis) and its point slice (points axis), runs
    every layer (`mlps`: one `mlp_apply` each) through the ring of its data
    slice, and returns its shard of the per-point features (B / D, N / P,
    F) and the global mean pool of its rows (B / D, F): the local sum,
    summed over the points axis, over N."""
    p, shards = _axis(mesh, POINTS_AXIS)
    group = mesh.get_group(mesh.mesh_dim_names.index(POINTS_AXIS))
    if data_axis is not None:
        d, rows = _axis(mesh, data_axis)
        if x.shape[0] % rows:
            raise ValueError(f'sharded_encoder_step: {x.shape[0]} clouds do not divide over '
                             f'{rows} ranks')
        n = x.shape[0] // rows
        x = x[d * n:(d + 1) * n]
    if x.shape[1] % shards:
        raise ValueError(f'sharded_encoder_step: {x.shape[1]} points do not divide over '
                         f'{shards} shards')
    S = x.shape[1] // shards
    h = x[:, p * S:(p + 1) * S].contiguous()
    for mlp_apply, aggr in zip(mlps, aggrs or ['max'] * len(mlps)):
        h = ring_edgeconv(h, mlp_apply, k, group, aggr)
    return h, all_reduce_sum(torch.sum(h, dim=1), group) / (S * shards)
