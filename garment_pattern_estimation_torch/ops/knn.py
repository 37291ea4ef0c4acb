"""kNN selection: the ranking contract, the bf16 truncation split, and the
standalone small-D kNN.

Neighbour selection ranks (quantized squared distance, column) pairs
lexicographically: the distance's f32 bit pattern with its low 11 bits
cleared, which keeps its top 21 bits (sign, 8 exponent bits, 12 fraction
bits), then the column. Non-negative f32 bit patterns order like their
values, so ties go to the lower column. Slot 0 is the query itself; slots
1..k-1 are the k-1 smallest pairs over the other columns. The kernels pack
a pair into one int32 (the column in the cleared bits) up to 2048 columns
and into one int64 (a global column) beyond; both rank alike.

`knn(points, k)` gives ids (B, N, k) for D <= 16. A CPU tensor takes
`knn_reference`, the plain PyTorch version (exact f32 distances summed per
dimension in dimension order); a CUDA tensor launches the hand-written
kernel `csrc/knn.cu` or raises. Counterpart of
garment_pattern_estimation_tpu/ops/knn.py `knn_pallas` with its direct
kernel `_knn_kernel_direct` (D <= 16); the wide-D kernels `_knn_kernel` and
`_knn_kernel_hbm` are not ported yet (ROADMAP queue B rows 2-3).
"""
from __future__ import annotations

import ctypes

import torch

IDX_BITS = 11                      # int32 packing of the single-tile kernels
IDX_MASK = (1 << IDX_BITS) - 1
INT_MAX = torch.iinfo(torch.int32).max
MAX_N = 1 << IDX_BITS              # columns the int32 packing can carry
DIRECT_D_MAX = 16                  # D at or below: exact per-dimension distances
_MAX_K = 8

# sign + exponent + top 7 fraction bits: exactly the bits of a bf16
_TRUNC_MASK = ~0xFFFF

# Launches of the CUDA kernel. Only `knn` adds to it, once per kernel
# launch; calls that take the plain version do not.
launches = {'knn': 0}


def reset_launches():
    for key in launches:
        launches[key] = 0


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def truncate_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> f32 with the low 16 bits cleared: truncation to bf16, not
    round-to-nearest. The result is exactly bf16-representable."""
    return (x.contiguous().view(torch.int32) & _TRUNC_MASK).view(torch.float32)


def split_bf16(x: torch.Tensor, terms: int = 2) -> list[torch.Tensor]:
    """f32 -> `terms` f32 chunks, each with <= 8 significant bits, summing to
    `x` up to a relative residual of about 2^(-8*terms). Each chunk is the
    remainder truncated; the remainder itself is exact (Sterbenz)."""
    chunks, r = [], x
    for _ in range(terms):
        c = truncate_bf16(r)
        chunks.append(c)
        r = r - c
    return chunks


def exact_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """(B, N, D) f32 -> (B, N, N) squared distances, (q - k)^2 summed in
    dimension order, each step rounded: the small-D kernels' arithmetic."""
    dists = None
    for dim in range(x.shape[-1]):
        diff = x[:, :, None, dim] - x[:, None, :, dim]
        sq = diff * diff
        dists = sq if dists is None else dists + sq
    return dists


def select_ranked(dists: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, N) f32 squared distances -> ids (B, N, k) int64: self in slot
    0, then the k-1 smallest (quantized distance, column) pairs over the
    other columns."""
    B, N, _ = dists.shape
    quantized = dists.view(torch.int32) & ~IDX_MASK
    del dists
    quantized.diagonal(dim1=1, dim2=2).fill_(INT_MAX)          # self
    col = torch.arange(N, device=quantized.device, dtype=torch.int64)
    key = (quantized.to(torch.int64) << 32) | col              # unique keys
    del quantized
    rest = torch.topk(key, k - 1, dim=-1, largest=False, sorted=True).values \
        & 0xFFFFFFFF
    return torch.cat([col[None, :, None].expand(B, N, 1), rest], dim=-1)


def _check_d(points):
    if points.dim() != 3:
        raise ValueError(f'knn: points must be (B, N, D), got {tuple(points.shape)}')
    if points.shape[-1] > DIRECT_D_MAX:
        raise NotImplementedError(
            f'knn: D={points.shape[-1]} > {DIRECT_D_MAX} needs the wide-D kernels '
            '(_knn_kernel, _knn_kernel_hbm), not ported yet')


def knn_reference(points, k):
    """Plain PyTorch kNN, D <= 16: ids (B, N, min(k, N)) int64."""
    _check_d(points)
    k = min(k, points.shape[1])
    return select_ranked(exact_sq_dists(points.float()), k)


def knn(points, k, *, tile_n=None):
    """points (B, N, D), D <= 16 -> ids (B, N, min(k, N)) int64, self in
    slot 0. A CPU tensor takes `knn_reference`; a CUDA tensor launches the
    kernel or raises. `tile_n` (CUDA only) forces the int64-ranked kernel
    with key windows of that many columns, as the TPU kernel's `tile_n`
    forces its column tiles."""
    _check_d(points)
    if points.device.type == 'cpu':
        return knn_reference(points, k)
    if points.device.type != 'cuda':
        raise ValueError(f'knn: unsupported device {points.device}')
    return _launch(points, k, tile_n)


def _launch(points, k, tile_n):
    from . import _build

    if points.dtype != torch.float32:
        raise TypeError(f'knn: points must be float32, got {points.dtype}')
    points = points.contiguous()
    B, N, D = points.shape
    k = min(k, N)
    if not 1 <= k <= _MAX_K:
        raise NotImplementedError(f'knn: k={k} is beyond the kernel (1 <= k <= {_MAX_K})')
    if tile_n is not None and not 1 <= tile_n <= MAX_N:
        raise ValueError(f'knn: tile_n={tile_n} is outside 1..{MAX_N}')
    idx = torch.empty(B, N, k, device=points.device, dtype=torch.int32)
    fn = _build.load_library('knn').knn_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    err = fn(points.data_ptr(), idx.data_ptr(), B, N, D, k, tile_n or 0,
             torch.cuda.current_stream(points.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'knn: kernel launch failed with CUDA error {err}')
    launches['knn'] += 1
    return idx.long()
