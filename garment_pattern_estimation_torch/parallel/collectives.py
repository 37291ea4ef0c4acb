"""Autograd-aware collectives of the port's data and points parallelism.

The JAX step over a mesh gets these from XLA: the gradient psum, the
cross-shard sums of a sharded step, the ring's `ppermute`. Here each is a
`torch.autograd.Function` whose backward is written out, over a process
group (None: the default group). What a backward does follows from how the
forward's output is used:

  * `all_reduce_sum`: each rank's input is its share of a sum (a BatchNorm
    moment of its rows) and each rank uses the replicated sum for its own
    rows only, so each rank's cotangent is a share too: the backward sums
    the cotangents over the group.
  * `all_gather_rows`: the gathered batch feeds a computation that every
    rank repeats identically (the loss on the whole batch), so its cotangent
    is the same on every rank: the backward keeps this rank's rows and
    reduces nothing. (`torch.distributed.nn.functional.all_reduce` sums the
    cotangent of a replicated output, which counts such a gradient once per
    rank.)
  * `ring_shift`: the cotangent travels the ring the other way.
  * `all_reduce_max` and `gather_points` on the points group: their output
    feeds a computation that every points rank repeats, and only one rank
    backpropagates the loss (the others backpropagate zeros), so each
    backward first sums the cotangents over the group, then hands this
    rank its share: the elements that hold the maximum, or its points.
    (`all_gather_rows` would keep each rank's own cotangent and drop every
    share but the backpropagating rank's.)

`sum_gradients` sums the parameters' gradients over the data group after the
backward, the counterpart of XLA's gradient psum: each rank's gradient is
the share of its own rows. `is_first_rank`, `broadcast_object` and
`barrier` let one rank write files and the others follow; without a
process group they are no-ops.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def initialized() -> bool:
    """Whether a default process group exists."""
    return dist.is_available() and dist.is_initialized()


def is_first_rank() -> bool:
    """True without a process group, else whether this is global rank 0."""
    return not initialized() or dist.get_rank() == 0


def broadcast_object(value):
    """Rank 0's `value` on every rank (picklable); `value` itself without a
    process group."""
    if not initialized():
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier():
    """Wait for every rank of the default group; nothing without one."""
    if initialized():
        if dist.get_backend() == 'nccl':
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def _global(group, rank):
    return dist.get_global_rank(group or dist.group.WORLD, rank)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x, group=None):
    """The sum of `x` over the group, on every rank; its backward sums the
    cotangents (each rank's use of the sum is its share)."""
    return _AllReduceSum.apply(x, group)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        size = dist.get_world_size(group)
        ctx.rows = x.shape[0]
        ctx.rank = dist.get_rank(group)
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def all_gather_rows(x, group=None):
    """Every rank's `x` (the same shape on each) stacked along dim 0 in rank
    order, on every rank. The output must feed a computation that every rank
    repeats identically: the backward keeps this rank's rows of the
    cotangent."""
    return _AllGatherRows.apply(x, group)


class _AllReduceMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        out = torch.amax(x, dim=dim)
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
        with torch.no_grad():
            hits = x == out.unsqueeze(dim)
            count = hits.sum(dim=dim, dtype=torch.float32)
            dist.all_reduce(count, group=group)
        ctx.save_for_backward(hits, count)
        ctx.dim, ctx.group = dim, group
        return out

    @staticmethod
    def backward(ctx, g):
        hits, count = ctx.saved_tensors
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        share = (g / count).to(g.dtype).unsqueeze(ctx.dim)
        return torch.where(hits, share, 0.0), None, None


def all_reduce_max(x, dim, group=None):
    """The maximum of `x` over its axis `dim` and over the group's ranks
    (each holding its part of that axis), on every rank. The backward sums
    the cotangents over the group and splits each evenly among the
    elements, on every rank, that equal the maximum: the gradient of
    `torch.amax` (and of `jnp.max`) over the whole axis."""
    return _AllReduceMax.apply(x, dim, group)


class _GatherPoints(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sizes, group):
        rank = dist.get_rank(group)
        ctx.group, ctx.span = group, (sum(sizes[:rank]), sizes[rank])
        width = max(sizes)
        padded = x if x.shape[1] == width else torch.cat(
            [x, x.new_zeros(x.shape[0], width - x.shape[1], *x.shape[2:])], dim=1)
        parts = [torch.empty_like(padded) for _ in sizes]
        dist.all_gather(parts, padded.contiguous(), group=group)
        return torch.cat([part[:, :n] for part, n in zip(parts, sizes)], dim=1)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        start, n = ctx.span
        return g[:, start:start + n], None, None


def gather_points(x, group=None, sizes=None):
    """Every rank's `x` (B, n_r, ...) joined along dim 1 in rank order (the
    global point order of contiguous shards), on every rank. `sizes` lists
    each rank's n_r (None: all equal to this rank's). The backward sums the
    cotangents over the group and keeps this rank's points (a
    reduce-scatter)."""
    if sizes is None:
        sizes = [x.shape[1]] * dist.get_world_size(group)
    return _GatherPoints.apply(x, list(sizes), group)


def _shift(x, group, step):
    """Send `x` `step` ranks on around the group's ring and receive from
    `step` ranks back. Under gloo a card's tensor travels through the host
    (gloo sends host memory)."""
    size = dist.get_world_size(group)
    if size == 1:
        return x.clone()
    rank = dist.get_rank(group)
    staged = x.is_cuda and dist.get_backend(group) == 'gloo'
    send = x.detach().cpu() if staged else x.contiguous()
    out = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, _global(group, (rank + step) % size), group),
           dist.P2POp(dist.irecv, out, _global(group, (rank - step) % size), group)]
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return out.to(x.device) if staged else out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def ring_shift(x, group=None):
    """The previous rank's `x` (rank r receives rank r - 1's, rank 0 the
    last rank's), as `lax.ppermute` with the pairs (i, i + 1). The backward
    sends each cotangent back to the rank its value came from."""
    return _RingShift.apply(x, group)


@torch.no_grad()
def sum_gradients(parameters, group=None):
    """Sum each parameter's `.grad` over the group in one flat all-reduce,
    in place. Parameters without a gradient are skipped (the same ones on
    every rank: each runs the same code)."""
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
