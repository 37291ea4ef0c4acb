"""Card-only tests of the port's CUDA kernel: each skips without a CUDA
device, since a CUDA kernel has no CPU mode. This file imports no JAX, so it
runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider

(`--noconftest`: the suite's conftest imports JAX.)

The kernel is held against the plain PyTorch version on the same card.
Neighbour ids: exact for small C (both sum the per-dimension squares in the
same order without FMA); for wide C the sum orders differ, so ids may differ
where two quantized distances share a bucket, and at least 99% must agree.
Outputs: against the plain MLP tail run on the kernel's own neighbours, to
1e-2 of the output's largest magnitude (a flipped bf16 truncation moves an
activation by up to 2^-8 of itself) and 1e-4 of it on average.
"""
import numpy as np
import pytest
import torch

from garment_pattern_estimation_torch.ops import edgeconv

pytestmark = pytest.mark.cuda


@pytest.fixture()
def rng():
    return np.random.default_rng(42)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


def _folded(rng, c, widths, device):
    layers = []
    for fan_in, fan_out in zip([2 * c, *widths[:-1]], widths):
        layers.append(tuple(torch.from_numpy(v.astype(np.float32)) for v in (
            rng.normal(size=(fan_out, fan_in)) * 0.3, rng.normal(size=fan_out) * 0.1,
            rng.uniform(0.5, 1.5, fan_out), rng.normal(size=fan_out) * 0.1,
            rng.normal(size=fan_out) * 0.1, rng.uniform(0.5, 2.0, fan_out))))
    layers, (a, d) = edgeconv.fold_mlp_bn(layers)
    return [(w.to(device), b.to(device)) for w, b in layers], (a.to(device), d.to(device))


@pytest.mark.parametrize('n_points,C,k,mlp_dtype', [
    (200, 3, 5, torch.float32),
    (77, 3, 3, torch.float32),        # ragged last query tile, another k
    (200, 24, 5, torch.float32),
    (300, 150, 5, torch.float32),     # more than two key tiles
    (300, 150, 5, torch.bfloat16),
])
def test_kernel_matches_plain(cuda, rng, n_points, C, k, mlp_dtype):
    folded = _folded(rng, C, [200, 200, 150], cuda)
    x = torch.from_numpy(rng.normal(size=(2, n_points, C)).astype(np.float32)).to(cuda)
    before = dict(edgeconv.launches)
    out, idx = edgeconv.fused_edgeconv(x, folded, k=k, mlp_dtype=mlp_dtype,
                                       return_idx=True)
    torch.cuda.synchronize()
    variant = 'small_c' if C <= edgeconv.SMALL_C_MAX else 'wide_c'
    assert edgeconv.launches[variant] == before[variant] + 1
    ref_idx, x_lp = edgeconv.edgeconv_select(x, k, mlp_dtype)
    if C <= edgeconv.SMALL_C_MAX:
        assert torch.equal(idx, ref_idx)
    else:
        assert (idx == ref_idx).float().mean().item() >= 0.99
    tail = edgeconv.edgeconv_mlp_max(x, idx, x_lp, folded).cpu().numpy()
    scale = float(np.abs(tail).max())
    diff = np.abs(out.cpu().numpy() - tail)
    assert diff.max() <= 1e-2 * scale and diff.mean() <= 1e-4 * scale


def test_large_n_raises(cuda, rng):
    folded = _folded(rng, 3, [8, 8], cuda)
    with pytest.raises(NotImplementedError, match='_fused_kernel_stream'):
        edgeconv.fused_edgeconv(torch.zeros(1, 4096, 3, device=cuda), folded, k=5)


def test_wrong_dtype_raises(cuda, rng):
    folded = _folded(rng, 3, [8, 8], cuda)
    with pytest.raises(TypeError):
        edgeconv.fused_edgeconv(torch.zeros(1, 64, 3, device=cuda,
                                            dtype=torch.float64), folded, k=5)
