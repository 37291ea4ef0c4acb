"""Fused dynamic EdgeConv: kNN + neighbour gather + edge MLP + max.

`fused_edgeconv` is the eval layer, for N <= MAX_FUSED_N (16384), any C
and k <= N, an edge MLP of any depth whose widths (and 2C) are at most
MAX_FUSED_WIDTH (2048). On a CUDA tensor it launches the hand-written
kernels of `csrc/fused_edgeconv.cu` or raises: one launch up to k = 128, C =
256 and the widths whose edge rows fit shared memory, else a selection
launch and an edge-MLP launch over its ids (the (B, N, k, C) gathered
tensor never reaches device memory either way). On a CPU tensor it runs
`fused_edgeconv_reference`, the plain PyTorch version with the same
numerics at any N:

  * selection by (quantized distance, column), self in slot 0, the k-1
    nearest others after it, ties to the lower column (`knn.select_ranked`);
  * small C (<= 16): exact f32 distances summed per dimension, exact rows;
  * wide C: q_norm + k_norm - 2 * (hi.hi + hi.lo + lo.hi) on bf16
    truncation splits, gathered rows hi + lo (f32 mode) or hi (bf16 mode);
  * edge MLP on [x_i ; x_j - x_i] with eval BatchNorm folded in
    (`fold_mlp_bn`): activations truncated to bf16, weights rounded to
    bf16, f32 accumulation, ReLU, the final affine h * a + d, max over k.

Counterpart of garment_pattern_estimation_tpu/ops/edgeconv.py
`fused_edgeconv`: the single-tile `_fused_kernel` up to 2048 points, the
column-tiled `_fused_kernel_direct_tiled` (small C) and
`_fused_kernel_stream` (wide C) beyond. Eval only: training needs batch
statistics.
"""
from __future__ import annotations

import collections
import ctypes

import torch

from .knn import (DIRECT_D_MAX, MAX_N, exact_sq_dists, scratch_bytes, select_ranked,
                  split_bf16, truncate_bf16)

SMALL_C_MAX = DIRECT_D_MAX  # C at or below: the exact per-dimension path
MAX_FUSED_N = 1 << 14       # the JAX package's fused bound (_MAX_FUSED_N)
MODEL_C_MAX = 256           # C at or below: the models fuse (the JAX package's bound)
MAX_FUSED_WIDTH = 2048      # widest edge-MLP layer (and edge input 2C) the kernels take

# Launches of the CUDA kernels, one variant per layer: single tile
# (N <= 2048) or column-tiled; `launches_by_shape` by (variant, N, C, k)
# for the one-launch layers and by (variant + '_select' | '_mlp', N, C, k)
# for each launch of a two-launch layer (`ops.launches_by_variant` sums
# them by variant, a layer once). Only `fused_edgeconv` adds to them;
# calls that take the plain version do not.
VARIANTS = ('small_c', 'wide_c', 'small_c_tiled', 'wide_c_tiled')
launches_by_shape = collections.Counter()


def fused_edgeconv_supported(n_points, n_channels, widths=()):
    """Whether a model fuses an EdgeConv layer of (N, C) and edge-MLP
    `widths`: N <= MAX_FUSED_N and C <= 256, the JAX package's
    `fused_edgeconv_supported`, and every width at most MAX_FUSED_WIDTH,
    the kernels' bound (the layer's edge rows must fit shared memory).
    `models.blocks.EdgeConv` routes any other layer to knn_gather (N <=
    2048) or the standalone kNN, then the edge MLP and the max."""
    return (n_points <= MAX_FUSED_N and n_channels <= MODEL_C_MAX
            and max(widths, default=0) <= MAX_FUSED_WIDTH)


def fold_mlp_bn(layers, eps=1e-5):
    """Fold eval BatchNorm of a Dense -> ReLU -> BN stack into the next
    layer.

    `layers`: per layer (linear weight (out, in), linear bias, bn weight,
    bn bias, running mean, running var). With z_l = h @ W_l + b_l and
    BN(relu(z_l)) = relu(z_l) * a_l + d_l (a = scale / sqrt(var + eps),
    d = bias - mean * a): W'_{l+1} = a_l[:, None] * W_{l+1} and
    b'_{l+1} = b_{l+1} + d_l @ W_{l+1}. Returns ([(W (in, out), b)] per
    layer, (a, d) of the final layer)."""
    folded = []
    a_prev = d_prev = None
    a = d = None
    for weight, bias, bn_w, bn_b, mean, var in layers:
        W = weight.float().t()
        b = bias.float()
        if a_prev is not None:
            b = b + d_prev @ W
            W = a_prev[:, None] * W
        folded.append((W.contiguous(), b))
        a = bn_w.float() * torch.rsqrt(var.float() + eps)
        d = bn_b.float() - mean.float() * a
        a_prev, d_prev = a, d
    return folded, (a, d)


def edgeconv_sq_dists(queries, keys):
    """(B, S, C) queries x (B, T, C) keys, f32 -> (B, S, T) squared
    distances as the fused layer and knn_gather rank them: exact f32 per
    dimension in dimension order for C <= SMALL_C_MAX (`knn.exact_sq_dists`);
    else q_norm + k_norm - 2 * (hi.hi + hi.lo + lo.hi) of the bf16
    truncation splits, clamped at 0. The selection of a whole cloud calls it
    with the cloud as both; the points-sharded ring
    (`parallel.ring.ring_knn_gather`) with a query shard and a key shard."""
    if queries.shape[-1] <= SMALL_C_MAX:
        return exact_sq_dists(queries, keys)
    q_norm = torch.sum(queries * queries, dim=-1)
    k_norm = torch.sum(keys * keys, dim=-1)
    q_hi, q_lo = split_bf16(queries)
    k_hi, k_lo = split_bf16(keys)
    # each partial product is exact (bf16-exact operands); TF32 is off
    cross = q_hi @ k_hi.transpose(1, 2)
    cross = cross + q_hi @ k_lo.transpose(1, 2)
    cross = cross + q_lo @ k_hi.transpose(1, 2)
    return torch.clamp_min(q_norm[:, :, None] + k_norm[:, None, :] - 2 * cross, 0.0)


def gathered_rows(x, value_chunks=2):
    """The rows (..., C) f32 that the kernels gather for slots >= 1: exact
    for C <= SMALL_C_MAX, else the bf16 truncation split hi + lo
    (value_chunks 2, the f32 mode) or hi (1, the bf16 mode)."""
    if x.shape[-1] <= SMALL_C_MAX:
        return x
    hi, lo = split_bf16(x)
    return hi + lo if value_chunks == 2 else hi


def edgeconv_select(x, k, mlp_dtype=torch.float32):
    """Neighbour ids (B, N, k) int64 and the rows to gather (B, N, C) f32.

    Slot 0 is the query itself; slots 1..k-1 hold the k-1 smallest
    (quantized distance, column) pairs over the other columns, compared
    lexicographically: the kernels' selection for any N."""
    k = min(k, x.shape[1])
    xf = x.float()
    ids = select_ranked(edgeconv_sq_dists(xf, xf), k)
    return ids, gathered_rows(xf, 2 if mlp_dtype == torch.float32 else 1)


def edgeconv_mlp_max(x, idx, x_lp, folded):
    """Edge MLP on [x_i ; x_j - x_i] for the chosen neighbours, then the max
    over the k slots. Slot 0 uses the query's own f32 row."""
    layers, (a, d) = folded
    B, N, C = x.shape
    xf = x.float()
    flat = idx + (torch.arange(B, device=x.device) * N)[:, None, None]
    nbr = x_lp.reshape(B * N, C)[flat.reshape(-1)].reshape(B, N, -1, C)
    nbr[:, :, 0, :] = xf
    center = xf[:, :, None, :].expand_as(nbr)
    h = torch.cat([center, nbr - center], dim=-1)
    del nbr
    for w, b in layers:
        w_bf = w.to(torch.bfloat16).float()
        h = torch.relu(truncate_bf16(h) @ w_bf + b)
    out = h * a + d
    return torch.amax(out, dim=2)


def fused_edgeconv_reference(x, folded, k, mlp_dtype=torch.float32,
                             return_idx=False):
    """Plain PyTorch version of the fused layer: (B, N, C) -> (B, N, H)."""
    idx, x_lp = edgeconv_select(x, k, mlp_dtype)
    out = edgeconv_mlp_max(x, idx, x_lp, folded)
    return (out, idx) if return_idx else out


def fused_edgeconv(x, folded, k, *, mlp_dtype=torch.float32, return_idx=False,
                   tile_n=None):
    """x (B, N, C), N <= MAX_FUSED_N, `fold_mlp_bn` output -> EdgeConv
    features (B, N, H).

    Runs the registered operator `gpe_torch::fused_edgeconv`, which the
    dispatcher sends by the tensor's device: a CPU tensor takes the plain
    version, a CUDA tensor launches the kernel or raises. `return_idx` also
    returns the neighbour ids (B, N, k). `tile_n` (CUDA only) forces the
    column-tiled variants at any N, with small-C key windows of that many
    columns, as the TPU kernel's `tile_n` forces its column tiles; the
    wide-C variant streams 128-key tiles whatever it is."""
    if x.shape[1] > MAX_FUSED_N:
        raise NotImplementedError(
            f'fused_edgeconv: N={x.shape[1]} > {MAX_FUSED_N}; such clouds take '
            'the unfused kNN path (models.blocks.EdgeConv: standalone kNN + '
            'gather + edge MLP)')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'fused_edgeconv: unsupported device {x.device}')
    if mlp_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'fused_edgeconv: mlp_dtype {mlp_dtype} is not supported')
    layers, (a, d) = folded
    out, idx = fused_edgeconv_op(x, [w for w, _ in layers], [b for _, b in layers], a, d, k,
                                 mlp_dtype == torch.bfloat16, tile_n or 0, return_idx)
    return (out, idx) if return_idx else out


# The fused layer as one operator, so that `torch.export` records it as a
# call (its kernel takes raw pointers, which a traced FakeTensor has not)
# and an exported program launches the kernel at run time. Plain types
# only: `bf16` selects mlp_dtype=bfloat16, `tile_n` 0 is None. The ids are
# an empty tensor unless `return_idx`.
@torch.library.custom_op('gpe_torch::fused_edgeconv', mutates_args=(), device_types='cpu')
def fused_edgeconv_op(x: torch.Tensor, weights: list[torch.Tensor],
                      biases: list[torch.Tensor], a: torch.Tensor, d: torch.Tensor, k: int,
                      bf16: bool, tile_n: int, return_idx: bool
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    out, idx = fused_edgeconv_reference(
        x, (list(zip(weights, biases)), (a, d)), k,
        torch.bfloat16 if bf16 else torch.float32, return_idx=True)
    return out, idx.contiguous() if return_idx else _no_ids(x)


@fused_edgeconv_op.register_kernel('cuda')
def _fused_edgeconv_cuda(x, weights, biases, a, d, k, bf16, tile_n, return_idx):
    return _launch(x, (list(zip(weights, biases)), (a, d)), k,
                   torch.bfloat16 if bf16 else torch.float32, return_idx, tile_n or None)


@fused_edgeconv_op.register_fake
def _fused_edgeconv_fake(x, weights, biases, a, d, k, bf16, tile_n, return_idx):
    B, N, _ = x.shape
    out = x.new_empty((B, N, weights[-1].shape[1]), dtype=torch.float32)
    return out, x.new_empty((B, N, min(k, N)), dtype=torch.int64) if return_idx \
        else _no_ids(x)


def _no_ids(x):
    return x.new_empty((0,), dtype=torch.int64)


def _pack_weight(w):
    """(in, out) f32 -> bf16 (round to nearest) in the kernel's mma.sync
    B-fragment order, zero-padded to (Din, Dout) = (in, out) rounded up to
    multiples of 16: element ((ks * Dout / 8 + nt) * 32 + L) * 4 + 2 r + e
    is W[16 ks + 8 r + 2 (L % 4) + e, 8 nt + L // 4]."""
    din, dout = w.shape
    ks, n_tiles = -(-din // 16), 2 * -(-dout // 16)
    padded = torch.zeros(16 * ks, 8 * n_tiles, device=w.device, dtype=torch.float32)
    padded[:din, :dout] = w
    # rows 16 ks + 8 r + 2 lq + e, columns 8 nt + lg; lane L = 4 lg + lq
    return padded.view(ks, 2, 4, 2, n_tiles, 8).permute(0, 4, 5, 2, 1, 3) \
        .contiguous().to(torch.bfloat16).reshape(-1)


def _pad_vector(v):
    """f32 zero-padded to its length rounded up to 16 (the kernel reads a
    layer's padded width)."""
    padded = torch.zeros(-(-v.shape[0] // 16) * 16, device=v.device, dtype=torch.float32)
    padded[:v.shape[0]] = v
    return padded


def _layer_table(weights, biases, dims, device):
    """The kernel's layer table in device memory (int64): the weights'
    pointers, the biases', then the widths."""
    return torch.tensor([w.data_ptr() for w in weights] + [b.data_ptr() for b in biases]
                        + dims, dtype=torch.int64).to(device)


def _launch(x, folded, k, mlp_dtype, return_idx, tile_n):
    from . import _build

    layers, (a, d) = folded
    if x.dtype != torch.float32:
        raise TypeError(f'fused_edgeconv: x must be float32, got {x.dtype}')
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError('fused_edgeconv: x must be a contiguous (B, N, C) tensor')
    B, N, C = x.shape
    k = min(k, N)
    if tile_n is not None and not 1 <= tile_n <= MAX_N:
        raise ValueError(f'fused_edgeconv: tile_n={tile_n} is outside 1..{MAX_N}')
    dims = [2 * C] + [w.shape[1] for w, _ in layers]
    if layers[0][0].shape[0] != 2 * C:
        raise ValueError(f'fused_edgeconv: edge MLP widths {dims} do not fit C={C}')
    if max(dims) > MAX_FUSED_WIDTH:
        raise NotImplementedError(
            f'fused_edgeconv: edge MLP widths {dims} pass {MAX_FUSED_WIDTH}, beyond the '
            'kernels\' shared memory; models.blocks.EdgeConv takes such a layer through '
            'knn_gather or the standalone kNN (fused_edgeconv_supported)')
    for t in [t for layer in layers for t in layer] + [a, d]:
        if t.device != x.device:
            raise ValueError('fused_edgeconv: weights and x are on different devices')

    weights = [_pack_weight(w.float()) for w, _ in layers]
    biases = [_pad_vector(b.float()) for _, b in layers]
    a_pad, d_pad = _pad_vector(a.float()), _pad_vector(d.float())
    table = _layer_table(weights, biases, dims, x.device)

    lib = _build.load_library('fused_edgeconv')
    fn_launches = lib.fused_edgeconv_launches
    fn_launches.restype = ctypes.c_int
    fn_launches.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int]
    dims_arr = (ctypes.c_int * len(dims))(*dims)
    n_launches = fn_launches(N, C, k, len(layers), ctypes.addressof(dims_arr), tile_n or 0)
    if n_launches not in (1, 2):
        raise NotImplementedError(
            f'fused_edgeconv: N={N}, C={C}, k={k}, widths {dims} is beyond the kernels')
    out = torch.empty(B, N, dims[-1], device=x.device, dtype=torch.float32)
    # a two-launch layer passes its ids from the first launch to the second
    idx = torch.empty(B, N, k, device=x.device, dtype=torch.int32) \
        if return_idx or n_launches == 2 else None

    scratch = torch.empty(scratch_bytes(lib, 'fused_edgeconv', B, N, C), device=x.device,
                          dtype=torch.uint8)
    fn = lib.fused_edgeconv_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_size_t] + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p] * 5
    with torch.cuda.device(x.device):            # the launch goes to the current device
        err = fn(x.data_ptr(), out.data_ptr(), idx.data_ptr() if idx is not None else None,
                 scratch.data_ptr(), scratch.numel(), B, N, C, k,
                 2 if mlp_dtype == torch.float32 else 1, len(layers),
                 tile_n or 0, ctypes.addressof(dims_arr), table.data_ptr(),
                 a_pad.data_ptr(), d_pad.data_ptr(),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'fused_edgeconv: kernel launch failed with CUDA error {err}')
    variant = ('small_c' if C <= SMALL_C_MAX else 'wide_c') \
        + ('_tiled' if N > MAX_N or tile_n is not None else '')
    if n_launches == 1:
        launches_by_shape[variant, N, C, k] += 1
    else:
        launches_by_shape[variant + '_select', N, C, k] += 1
        launches_by_shape[variant + '_mlp', N, C, k] += 1
    return out, idx.long() if return_idx else _no_ids(x)
