"""Packing constants and the bf16 truncation split of the kNN selection.

Only what the fused EdgeConv layer needs; the standalone kNN kernels of the
JAX package (`ops/knn.py` there) are not ported yet (ROADMAP queue B).

Neighbour selection runs on packed int32 values: the squared distance's f32
bit pattern with its low 11 bits replaced by the column index. Non-negative
f32 bit patterns order like their values, so one integer min picks the
nearest remaining neighbour, ties going to the lower column. The distance
keeps its top 21 bits (sign, 8 exponent bits, 12 fraction bits), which is
the selection's quantization."""
from __future__ import annotations

import torch

IDX_BITS = 11                      # packed column ids: N <= 2048
IDX_MASK = (1 << IDX_BITS) - 1
INT_MAX = torch.iinfo(torch.int32).max
MAX_N = 1 << IDX_BITS

# sign + exponent + top 7 fraction bits: exactly the bits of a bf16
_TRUNC_MASK = ~0xFFFF


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
