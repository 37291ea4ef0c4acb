"""kNN + neighbour gather with its backward: the EdgeConv input of the
training path.

`knn_gather(x, k)` maps x (B, N, C) to the neighbour rows slot-major
(B, k, N, C) and the ids (B, N, k). Slot 0 is the query's own f32 row; the
k-1 nearest other points follow, chosen like the fused layer
(`edgeconv.edgeconv_select`: packed quantized distances, ties to the lower
column). Their rows are exact for C <= 16; for wider C they are the bf16
truncation split hi + lo (`value_chunks=2`) or hi (`value_chunks=1`). The
ids are not differentiable, and the gradient is the identity through the
gathered values: dx[i] = g[slot 0 of query i] + the sum of g over every
(query, slot >= 1) whose neighbour is i. Slot 0 is added at full f32; the
slots >= 1 add the full f32 cotangent (`value_chunks=2`, the two bf16
truncation chunks of the JAX kernel, exact in f32) or its top truncation
chunk only (`value_chunks=1`, the bf16 compute mode), as the JAX kernel's
`_bwd_kernel` scatters them.

A CPU tensor takes the plain versions (`knn_gather_reference`,
`knn_gather_backward_reference`, an `index_add_`); a CUDA tensor launches
the hand-written kernels of `csrc/knn_gather.cu` or raises.

Counterpart of garment_pattern_estimation_tpu/ops/knn_gather.py:264-347
(`knn_gather` with its custom VJP, `knn_gather_reference`).
"""
from __future__ import annotations

import collections
import ctypes

import torch

from .edgeconv import SMALL_C_MAX, edgeconv_select
from .knn import MAX_K, MAX_N, scratch_bytes, truncate_bf16

# Launches of the CUDA kernels, by variant ('bwd_hi': the backward at
# value_chunks=1), one per call; `launches_by_shape` by (variant, N, C, k),
# and for a forward at k > 128, which is two launches (the selection of
# all N keys, then the rows), by (variant + '_select' | '_rows', N, C, k).
# Only the wrappers add to them; calls that take the plain versions do not.
launches = {'fwd_small_c': 0, 'fwd_wide_c': 0, 'bwd': 0, 'bwd_hi': 0}
launches_by_shape = collections.Counter()


def reset_launches():
    for key in launches:
        launches[key] = 0
    launches_by_shape.clear()


def knn_gather_supported(n_points):
    """Whether the kernels take N points: N <= 2048, the int32 packing's
    columns, as the JAX package's `knn_gather_supported`."""
    return n_points <= MAX_N


def knn_gather_reference(x, k, value_chunks=2):
    """Plain PyTorch forward: (neighbours (B, k, N, C) f32, ids (B, N, k)
    int64). Not differentiable itself; `knn_gather` carries the gradient."""
    B, N, C = x.shape
    mlp_dtype = torch.float32 if value_chunks == 2 else torch.bfloat16
    idx, x_lp = edgeconv_select(x, k, mlp_dtype)
    flat = idx.transpose(1, 2) + (torch.arange(B, device=x.device) * N)[:, None, None]
    nbr = x_lp.reshape(B * N, C)[flat.reshape(-1)].reshape(B, -1, N, C)
    nbr[:, 0] = x.float()
    return nbr, idx


def knn_gather_backward_reference(idx, g, value_chunks=2, dtype=torch.float32):
    """Plain PyTorch backward: ids (B, N, k) and the neighbour cotangent
    g (B, k, N, C) -> dx (B, N, C) in `dtype`, slot 0 added to the query
    row at full f32 and slots 1..k-1 scatter-added into their neighbours'
    rows: at full f32 (`value_chunks=2`) or truncated to bf16
    (`value_chunks=1`, the low 16 bits cleared, not rounded). The sums run
    in `dtype`. On a CUDA tensor `index_add_` adds atomically, so at f32
    the order of a long sum, and its last bits, change from run to run;
    `dtype=torch.float64` gives an oracle of value that does not."""
    B, k, N, C = g.shape
    g = g.float()
    dx = g[:, 0].to(dtype, copy=True).contiguous()
    if k > 1:
        flat = idx[:, :, 1:].transpose(1, 2).long() \
            + (torch.arange(B, device=g.device) * N)[:, None, None]
        rows = g[:, 1:].reshape(-1, C)
        if value_chunks == 1:
            rows = truncate_bf16(rows)
        dx.view(B * N, C).index_add_(0, flat.reshape(-1), rows.to(dtype))
    return dx


def knn_gather_backward_ordered(idx, g, value_chunks=2):
    """The backward kernel's arithmetic in plain PyTorch: dx (B, N, C) f32,
    each target row summed as the kernel sums it, slot 0 first and then its
    contributions in ascending entry id e = n (k-1) + s - 1, one f32 add
    at a time. Bitwise equal to the kernel, and so its oracle of order on
    the card; `knn_gather_backward_reference` is the oracle of value. Ids
    outside [0, N) add nothing, as in the kernel. Slow for a hub: one round
    of adds per list position."""
    B, k, N, C = g.shape
    g = g.float()
    dx = g[:, 0].clone()
    if k == 1:
        return dx
    E = N * (k - 1)
    tgt = idx[:, :, 1:].reshape(B, E).long()
    rows = g[:, 1:].permute(0, 2, 1, 3).reshape(B * E, C)     # entry order
    if value_chunks == 1:
        rows = truncate_bf16(rows)
    valid = (tgt >= 0) & (tgt < N)
    flat = (tgt + (torch.arange(B, device=g.device) * N)[:, None]).reshape(-1)
    entry = torch.arange(B * E, device=g.device)
    order = torch.argsort(torch.where(valid.reshape(-1), flat, B * N) * (B * E) + entry)
    flat, entry = flat[order], entry[order]
    n_valid = int(valid.sum())
    flat, entry = flat[:n_valid], entry[:n_valid]
    # each entry's position within its target's list
    first = torch.ones_like(flat, dtype=torch.bool)
    first[1:] = flat[1:] != flat[:-1]
    starts = torch.cummax(torch.where(first, torch.arange(n_valid, device=g.device), 0), 0).values
    rank = torch.arange(n_valid, device=g.device) - starts
    out = dx.view(B * N, C)
    for r in range(int(rank.max()) + 1 if n_valid else 0):
        sel = rank == r                      # at most one entry per target
        out[flat[sel]] += rows[entry[sel]]
    return dx


def _check(x, k):
    if x.dtype != torch.float32:
        raise TypeError(f'knn_gather: x must be float32, got {x.dtype}')
    if x.dim() != 3:
        raise ValueError(f'knn_gather: x must be (B, N, C), got {tuple(x.shape)}')
    B, N, C = x.shape
    if not knn_gather_supported(N):
        raise NotImplementedError(
            f'knn_gather: N={N} > {MAX_N} exceeds the packed column ids; '
            'EdgeConv trains such clouds through the standalone kNN '
            '(models.blocks.EdgeConv)')
    if not 1 <= k <= N:
        raise NotImplementedError(f'knn_gather: k={k} is outside 1 <= k <= N = {N}')


def _library():
    from . import _build

    lib = _build.load_library('knn_gather')
    lib.knn_gather_forward.restype = ctypes.c_int
    lib.knn_gather_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_size_t] \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.knn_gather_backward.restype = ctypes.c_int
    lib.knn_gather_backward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_size_t] \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.knn_gather_bwd_scratch_bytes.restype = ctypes.c_size_t
    lib.knn_gather_bwd_scratch_bytes.argtypes = [ctypes.c_int] * 3
    return lib


def knn_gather_fwd(x, k, value_chunks=2):
    """The forward alone: (neighbours (B, k, N, C) f32, ids (B, N, k)).
    A CPU tensor takes `knn_gather_reference` (int64 ids); a CUDA tensor
    launches the forward kernel (int32 ids) or raises."""
    if x.device.type == 'cpu':
        return knn_gather_reference(x, k, value_chunks)
    if x.device.type != 'cuda':
        raise ValueError(f'knn_gather: unsupported device {x.device}')
    _check(x, k)
    x = x.contiguous()
    B, N, C = x.shape
    nbr = torch.empty(B, k, N, C, device=x.device, dtype=torch.float32)
    idx = torch.empty(B, N, k, device=x.device, dtype=torch.int32)
    lib = _library()
    scratch = torch.empty(scratch_bytes(lib, 'knn_gather', B, N, C), device=x.device,
                          dtype=torch.uint8)
    with torch.cuda.device(x.device):            # the launch goes to the current device
        err = lib.knn_gather_forward(
            x.data_ptr(), nbr.data_ptr(), idx.data_ptr(), scratch.data_ptr(), scratch.numel(),
            B, N, C, k, value_chunks, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'knn_gather: forward launch failed with CUDA error {err}')
    variant = 'fwd_small_c' if C <= SMALL_C_MAX else 'fwd_wide_c'
    launches[variant] += 1
    if k <= MAX_K:
        launches_by_shape[variant, N, C, k] += 1
    else:
        launches_by_shape[variant + '_select', N, C, k] += 1
        launches_by_shape[variant + '_rows', N, C, k] += 1
    return nbr, idx


def knn_gather_bwd(idx, g, value_chunks=2):
    """The backward alone: ids (B, N, k) and g (B, k, N, C) -> dx (B, N, C)
    f32, slots >= 1 at full f32 (`value_chunks=2`) or truncated to bf16
    (1). A CPU tensor takes `knn_gather_backward_reference`; a CUDA tensor
    launches the backward kernels (CSR build into a scratch of the
    library's `knn_gather_bwd_scratch_bytes(B, N, k)`, then the sum) or
    raises."""
    if value_chunks not in (1, 2):
        raise ValueError(f'knn_gather: value_chunks must be 1 or 2, got {value_chunks}')
    if g.device.type == 'cpu':
        return knn_gather_backward_reference(idx, g, value_chunks)
    if g.device.type != 'cuda' or idx.device != g.device:
        raise ValueError(f'knn_gather: unsupported devices {idx.device}, {g.device}')
    B, k, N, C = g.shape
    if tuple(idx.shape) != (B, N, k):
        raise ValueError(f'knn_gather: ids {tuple(idx.shape)} do not fit g {tuple(g.shape)}')
    if N > MAX_N or not 1 <= k <= N:
        raise NotImplementedError(
            f'knn_gather: backward of N={N}, k={k} is beyond the kernels '
            f'(N <= {MAX_N}, 1 <= k <= N)')
    idx = idx.to(torch.int32).contiguous()
    g = g.float().contiguous()
    dx = torch.empty(B, N, C, device=g.device, dtype=torch.float32)
    lib = _library()
    scratch = torch.empty(lib.knn_gather_bwd_scratch_bytes(B, N, k), device=g.device,
                          dtype=torch.uint8)
    with torch.cuda.device(g.device):
        err = lib.knn_gather_backward(
            idx.data_ptr(), g.data_ptr(), dx.data_ptr(), scratch.data_ptr(), scratch.numel(),
            B, N, C, k, value_chunks, torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'knn_gather: backward launch failed with CUDA error {err}')
    variant = 'bwd' if value_chunks == 2 else 'bwd_hi'
    launches[variant] += 1
    launches_by_shape[variant, N, C, k] += 1
    return dx


class KnnGather(torch.autograd.Function):
    """Forward: the kNN + gather (kernel 8 on the card); backward: the
    scatter-add of the neighbour cotangents (kernel 9 on the card: the
    transposed graph's CSR, then one gathered sum per target)."""

    @staticmethod
    def forward(ctx, x, k, value_chunks):
        nbr, idx = knn_gather_fwd(x, k, value_chunks)
        ctx.save_for_backward(idx)
        ctx.x_dtype = x.dtype
        ctx.value_chunks = value_chunks
        idx = idx.long()
        ctx.mark_non_differentiable(idx)
        return nbr, idx

    @staticmethod
    def backward(ctx, g, _):
        (idx,) = ctx.saved_tensors
        return knn_gather_bwd(idx, g, ctx.value_chunks).to(ctx.x_dtype), None, None


def knn_gather(x, k, value_chunks=2):
    """x (B, N, C) -> (neighbours (B, k, N, C) f32, ids (B, N, k) int64),
    differentiable in the gathered values. Requires k <= N: the slot count
    shapes what follows, so the caller clamps it."""
    if value_chunks not in (1, 2):
        raise ValueError(f'knn_gather: value_chunks must be 1 or 2, got {value_chunks}')
    if k > x.shape[1]:
        raise ValueError(f'knn_gather: k={k} exceeds the point count {x.shape[1]}')
    return KnnGather.apply(x, k, value_chunks)
