"""kNN selection: the ranking contracts, the bf16 truncation split, and the
standalone kNN.

Two rankings of (squared distance, column) pairs, both lexicographic with
ties to the lower column; slot 0 is the query itself and slots 1..k-1 are
the k-1 smallest pairs over the other columns.

  * quantized (the fused layer, knn_gather, and the kNN for D <= 16): the
    distance's f32 bit pattern with its low 11 bits cleared, which keeps
    its top 21 bits (sign, 8 exponent bits, 12 fraction bits); exact f32
    distances summed per dimension for D <= 16 (`exact_sq_dists`), 2-term
    split products for the fused layer's wider C. Non-negative f32 bit
    patterns order like their values. The kernels pack a pair into one
    int32 (the column in the cleared bits) up to 2048 columns and into one
    int64 (a global column) beyond; both rank alike (`select_ranked`).
  * exact (the kNN for D > 16): q_norm + k_norm - 2 * cross, cross from
    3-term bf16 truncation splits (six partial products), neither clamped
    at 0 nor quantized: ranked by the full f32 value, -0 tied with +0
    (`wide_sq_dists`, `select_exact`).

`knn(points, k)` gives ids (B, N, k) for k <= 128. A CPU tensor takes
`knn_reference`, the plain PyTorch version; a CUDA tensor launches the
hand-written kernel `csrc/knn.cu` (D <= 16) or `csrc/knn_wide.cu` (D > 16,
staged 256 features at a time past 256), or raises. Counterpart of
garment_pattern_estimation_tpu/ops/knn.py `knn_pallas`: its direct kernel
`_knn_kernel_direct` (D <= 16) and the wide-D kernels `_knn_kernel` and
`_knn_kernel_hbm`.
"""
from __future__ import annotations

import collections
import ctypes

import torch

IDX_BITS = 11                      # int32 packing of the single-tile kernels
IDX_MASK = (1 << IDX_BITS) - 1
INT_MAX = torch.iinfo(torch.int32).max
MAX_N = 1 << IDX_BITS              # columns the int32 packing can carry
DIRECT_D_MAX = 16                  # D at or below: exact per-dimension distances
# the kNN kernels' k: an instance per k to 8, one for 9..16, then one per
# capacity bucket 17..32, 33..64, 65..128 (k read at run time); the fused
# layer and knn_gather also take 128 < k <= N (a selection of all N keys)
MAX_K = 128
K_INSTANCES = 'an instance per k to 8, one for 9..16, 17..32, 33..64 and 65..128'
_SPLIT_TERMS = 3                   # truncation chunks of the wide-D distances
# partial products of the wide-D cross term, summed in this order: the
# JAX package's _CROSS_PAIRS[3]
_CROSS_PAIRS = ((0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (2, 0))

# sign + exponent + top 7 fraction bits: exactly the bits of a bf16
_TRUNC_MASK = ~0xFFFF

# Launches of the CUDA kernels, by (kernel, N, D, k): 'knn' (D <= 16),
# 'knn_wide' (D > 16). Only `knn` adds to them, once per kernel launch;
# calls that take the plain version do not.
VARIANTS = ('knn', 'knn_wide')
launches_by_shape = collections.Counter()


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


def exact_sq_dists(x: torch.Tensor, keys: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, D) f32 queries x (B, M, D) keys (None: the queries) -> (B, N,
    M) squared distances, (q - k)^2 summed in dimension order, each step
    rounded: the small-D kernels' arithmetic."""
    keys = x if keys is None else keys
    dists = None
    for dim in range(x.shape[-1]):
        diff = x[:, :, None, dim] - keys[:, None, :, dim]
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


def wide_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """(B, N, D) f32 -> (B, N, N) squared distances of the wide-D kNN:
    q_norm + k_norm - 2 * cross, the norms summed from the unsplit f32
    squares, cross the six partial products of the 3-term truncation
    splits in `_CROSS_PAIRS` order. Each product is exact (bf16-exact
    operands; TF32 is off); not clamped at 0."""
    norm = torch.sum(x * x, dim=-1)
    chunks = split_bf16(x, terms=_SPLIT_TERMS)
    cross = None
    for i, j in _CROSS_PAIRS:
        p = chunks[i] @ chunks[j].transpose(1, 2)
        cross = p if cross is None else cross + p
    return norm[:, :, None] + norm[:, None, :] - 2.0 * cross


def pairwise_sq_dists(queries: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """(..., M, D) x (..., N, D) -> (..., M, N) squared distances as the
    JAX package's `pairwise_sq_dists` forms them: q_norm + k_norm - 2 *
    cross, the norms and the product in f32 (TF32 is off), not clamped.
    Plain PyTorch: radius tests and rankings on it round as JAX's do."""
    q_norm = torch.sum(queries * queries, dim=-1, keepdim=True)
    k_norm = torch.sum(keys * keys, dim=-1, keepdim=True)
    cross = queries @ keys.transpose(-1, -2)
    return q_norm + k_norm.transpose(-1, -2) - 2.0 * cross


def order_preserving_bits(values: torch.Tensor) -> torch.Tensor:
    """f32 -> int32 whose signed order is the float order, -0 equal to +0:
    a negative value's bits below the sign flipped."""
    bits = (values + 0.0).contiguous().view(torch.int32)     # -0 + 0 = +0
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def select_exact(dists: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, N) f32 distances -> ids (B, N, k) int64: self in slot 0, then
    the k-1 smallest (exact distance, column) pairs over the other columns."""
    B, N, _ = dists.shape
    key = order_preserving_bits(dists).to(torch.int64) << 32
    del dists
    col = torch.arange(N, device=key.device, dtype=torch.int64)
    key |= col
    key.diagonal(dim1=1, dim2=2).fill_(torch.iinfo(torch.int64).max)   # self
    rest = torch.topk(key, k - 1, dim=-1, largest=False, sorted=True).values \
        & 0xFFFFFFFF
    return torch.cat([col[None, :, None].expand(B, N, 1), rest], dim=-1)


def _check_d(points):
    if points.dim() != 3:
        raise ValueError(f'knn: points must be (B, N, D), got {tuple(points.shape)}')


def knn_reference(points, k):
    """Plain PyTorch kNN at any D: ids (B, N, min(k, N)) int64."""
    _check_d(points)
    k = min(k, points.shape[1])
    x = points.float()
    if x.shape[-1] <= DIRECT_D_MAX:
        return select_ranked(exact_sq_dists(x), k)
    return select_exact(wide_sq_dists(x), k)


def knn(points, k, *, tile_n=None):
    """points (B, N, D) -> ids (B, N, min(k, N)) int64, self in slot 0. A
    CPU tensor takes `knn_reference`; a CUDA tensor launches the kernel of
    its D (k <= 128, as the JAX package's `knn_pallas`) or raises. `tile_n` (CUDA, D <= 16 only) forces the
    int64-ranked small-D kernel with key windows of that many columns, as
    the TPU kernel's `tile_n` forces its column tiles."""
    _check_d(points)
    if points.device.type == 'cpu':
        return knn_reference(points, k)
    if points.device.type != 'cuda':
        raise ValueError(f'knn: unsupported device {points.device}')
    if points.shape[-1] > DIRECT_D_MAX:
        if tile_n is not None:
            raise ValueError('knn: tile_n applies to the small-D kernel only')
        return _launch_wide(points, k)
    return _launch(points, k, tile_n)


def scratch_bytes(lib, name, B, N, C):
    """Bytes of device scratch that kernel library `lib`'s `name`_forward
    needs for a (B, N, C) input: `name`_scratch_bytes of the library (the
    wide selections' split rows; 0 where none is needed)."""
    fn = getattr(lib, f'{name}_scratch_bytes')
    fn.restype = ctypes.c_size_t
    fn.argtypes = [ctypes.c_int] * 3
    return fn(B, N, C)


def _check_launch(points, k):
    if points.dtype != torch.float32:
        raise TypeError(f'knn: points must be float32, got {points.dtype}')
    k = min(k, points.shape[1])
    if not 1 <= k <= MAX_K:
        raise NotImplementedError(
            f'knn: k={k} is beyond the kNN kernels (1 <= k <= {MAX_K}: {K_INSTANCES}), as '
            f'beyond the JAX package\'s knn_pallas; the fused layer (ops.edgeconv) and '
            f'knn_gather (ops.knn_gather) take 128 < k <= N')
    return points.contiguous(), k


def _launch(points, k, tile_n):
    from . import _build

    points, k = _check_launch(points, k)
    B, N, D = points.shape
    if tile_n is not None and not 1 <= tile_n <= MAX_N:
        raise ValueError(f'knn: tile_n={tile_n} is outside 1..{MAX_N}')
    idx = torch.empty(B, N, k, device=points.device, dtype=torch.int32)
    fn = _build.load_library('knn').knn_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    with torch.cuda.device(points.device):       # the launch goes to the current device
        err = fn(points.data_ptr(), idx.data_ptr(), B, N, D, k, tile_n or 0,
                 torch.cuda.current_stream(points.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'knn: kernel launch failed with CUDA error {err}')
    launches_by_shape['knn', N, D, k] += 1
    return idx.long()


def _launch_wide(points, k):
    from . import _build

    points, k = _check_launch(points, k)
    B, N, D = points.shape
    idx = torch.empty(B, N, k, device=points.device, dtype=torch.int32)
    lib = _build.load_library('knn_wide')
    # the kernel's scratch: each point split once into bf16 chunks + its norm
    scratch = torch.empty(scratch_bytes(lib, 'knn_wide', B, N, D), device=points.device,
                          dtype=torch.uint8)
    fn = lib.knn_wide_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_size_t] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    with torch.cuda.device(points.device):
        err = fn(points.data_ptr(), idx.data_ptr(), scratch.data_ptr(), scratch.numel(),
                 B, N, D, k, torch.cuda.current_stream(points.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'knn: wide-D kernel launch failed with CUDA error {err}')
    launches_by_shape['knn_wide', N, D, k] += 1
    return idx.long()
