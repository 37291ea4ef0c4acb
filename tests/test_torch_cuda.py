"""Card-only tests of the port's CUDA kernels: each skips without a CUDA
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

Past 2048 points the column-tiled variants rank (quantized distance,
column) in one int64 instead of one int32; forced onto 2000 points
(`tile_n`), they give ids and outputs bitwise equal to the single-tile
variants'. The standalone kNN's ids equal the plain version's exactly.

knn_gather: ids as above; gathered rows bitwise equal to the plain
version's where the ids agree (both copy or split the same f32 value);
dx within 1e-5 of its largest magnitude of the plain `index_add_` on the
kernel's own ids (the two sum the same f32 terms in another order), and
bitwise equal across two runs (the backward uses no float atomics).
"""
import numpy as np
import pytest
import torch

from garment_pattern_estimation_torch.ops import edgeconv, knn, knn_gather

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
    (3000, 3, 5, torch.float32),      # past 2048: the column-tiled variants
    (3000, 24, 5, torch.float32),
    (2049, 150, 5, torch.bfloat16),   # one column past the int32 packing
    (16384, 3, 3, torch.float32),     # the fused bound
    (2500, 3, 1, torch.float32),      # self only
])
def test_kernel_matches_plain(cuda, rng, n_points, C, k, mlp_dtype):
    folded = _folded(rng, C, [200, 200, 150], cuda)
    x = torch.from_numpy(rng.normal(size=(2, n_points, C)).astype(np.float32)).to(cuda)
    before = dict(edgeconv.launches)
    out, idx = edgeconv.fused_edgeconv(x, folded, k=k, mlp_dtype=mlp_dtype,
                                       return_idx=True)
    torch.cuda.synchronize()
    variant = ('small_c' if C <= edgeconv.SMALL_C_MAX else 'wide_c') \
        + ('_tiled' if n_points > knn.MAX_N else '')
    assert edgeconv.launches[variant] == before[variant] + 1
    assert sum(edgeconv.launches.values()) == sum(before.values()) + 1
    ref_idx, x_lp = edgeconv.edgeconv_select(x, k, mlp_dtype)
    if C <= edgeconv.SMALL_C_MAX:
        assert torch.equal(idx, ref_idx)
    else:
        assert (idx == ref_idx).float().mean().item() >= 0.99
    tail = edgeconv.edgeconv_mlp_max(x, idx, x_lp, folded).cpu().numpy()
    scale = float(np.abs(tail).max())
    diff = np.abs(out.cpu().numpy() - tail)
    assert diff.max() <= 1e-2 * scale and diff.mean() <= 1e-4 * scale


@pytest.mark.parametrize('C,tile_n', [(3, 512), (3, 2000), (24, 512)])
def test_tiled_variants_equal_single_tile_at_2000(cuda, rng, C, tile_n):
    """The int64 ranking and the key windows change no id and no output bit
    at the attention model's 2000 points."""
    folded = _folded(rng, C, [200, 200, 150], cuda)
    x = torch.from_numpy(rng.normal(size=(2, 2000, C)).astype(np.float32)).to(cuda)
    before = dict(edgeconv.launches)
    out, idx = edgeconv.fused_edgeconv(x, folded, k=5, return_idx=True)
    tiled_out, tiled_idx = edgeconv.fused_edgeconv(x, folded, k=5, return_idx=True,
                                                   tile_n=tile_n)
    torch.cuda.synchronize()
    variant = 'small_c' if C <= edgeconv.SMALL_C_MAX else 'wide_c'
    assert edgeconv.launches[variant] == before[variant] + 1
    assert edgeconv.launches[variant + '_tiled'] == before[variant + '_tiled'] + 1
    assert torch.equal(tiled_idx, idx)
    assert torch.equal(tiled_out, out)


def test_large_n_raises(cuda, rng):
    folded = _folded(rng, 3, [8, 8], cuda)
    with pytest.raises(NotImplementedError, match='unfused kNN path'):
        edgeconv.fused_edgeconv(torch.zeros(1, edgeconv.MAX_FUSED_N + 1, 3, device=cuda),
                                folded, k=5)


@pytest.mark.parametrize('shape,k,tile_n', [
    ((2, 5000, 3), 5, None),          # int64 ranking, three key windows
    ((2, 2000, 3), 5, None),          # int32 ranking, one window
    ((2, 2000, 3), 5, 300),           # int64 ranking forced, ragged windows
    ((1, 3000, 16), 8, None),
    ((3, 77, 8), 1, None),
    ((1, 2500, 3), 1, None),
    ((1, 16385, 3), 5, None),         # past the fused bound: the kNN has none
])
def test_knn_matches_plain(cuda, rng, shape, k, tile_n):
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    before = knn.launches['knn']
    ids = knn.knn(x, k, tile_n=tile_n)
    torch.cuda.synchronize()
    assert knn.launches['knn'] == before + 1
    assert torch.equal(ids, knn.knn_reference(x, k))


def test_knn_wrong_dtype_raises(cuda):
    with pytest.raises(TypeError):
        knn.knn(torch.zeros(1, 64, 3, device=cuda, dtype=torch.float64), 5)


def test_wrong_dtype_raises(cuda, rng):
    folded = _folded(rng, 3, [8, 8], cuda)
    with pytest.raises(TypeError):
        edgeconv.fused_edgeconv(torch.zeros(1, 64, 3, device=cuda,
                                            dtype=torch.float64), folded, k=5)


@pytest.mark.parametrize('n_points,C,k,value_chunks', [
    (200, 3, 5, 2),
    (77, 3, 3, 2),                    # ragged last query tile, another k
    (200, 24, 5, 2),
    (300, 150, 5, 2),                 # more than two key tiles
    (300, 150, 5, 1),
    (90, 150, 1, 2),                  # self only: the backward copies slot 0
])
def test_knn_gather_matches_plain(cuda, rng, n_points, C, k, value_chunks):
    x = torch.from_numpy(rng.normal(size=(2, n_points, C)).astype(np.float32)).to(cuda)
    x.requires_grad_(True)
    before = dict(knn_gather.launches)
    nbr, idx = knn_gather.knn_gather(x, k, value_chunks)
    g = torch.from_numpy(rng.normal(size=tuple(nbr.shape)).astype(np.float32)).to(cuda)
    (dx,) = torch.autograd.grad(nbr, x, g)
    torch.cuda.synchronize()
    variant = 'fwd_small_c' if C <= edgeconv.SMALL_C_MAX else 'fwd_wide_c'
    assert knn_gather.launches[variant] == before[variant] + 1
    assert knn_gather.launches['bwd'] == before['bwd'] + 1

    ref_nbr, ref_idx = knn_gather.knn_gather_reference(x.detach(), k, value_chunks)
    if C <= edgeconv.SMALL_C_MAX:
        assert torch.equal(idx, ref_idx)
    else:
        assert (idx == ref_idx).float().mean().item() >= 0.99
    agree = (idx == ref_idx).transpose(1, 2)                       # (B, k, N)
    assert torch.equal(nbr[agree], ref_nbr[agree])

    ref_dx = knn_gather.knn_gather_backward_reference(idx, g)
    scale = ref_dx.abs().max().item()
    assert (dx - ref_dx).abs().max().item() <= 1e-5 * scale
    (dx_again,) = torch.autograd.grad(knn_gather.knn_gather(x, k, value_chunks)[0], x, g)
    assert torch.equal(dx, dx_again)


def test_knn_gather_ids_equal_the_fused_kernels(cuda, rng):
    """One selection code: the fused layer and knn_gather pick the same ids."""
    folded = _folded(rng, 150, [16, 16], cuda)
    x = torch.from_numpy(rng.normal(size=(2, 300, 150)).astype(np.float32)).to(cuda)
    _, fused_idx = edgeconv.fused_edgeconv(x, folded, k=5, return_idx=True)
    _, idx = knn_gather.knn_gather(x, 5)
    assert torch.equal(idx, fused_idx)


def test_knn_gather_large_n_raises(cuda):
    with pytest.raises(NotImplementedError, match='N=4096'):
        knn_gather.knn_gather(torch.zeros(1, 4096, 3, device=cuda), 5)


def test_knn_gather_wrong_dtype_raises(cuda):
    with pytest.raises(TypeError):
        knn_gather.knn_gather(torch.zeros(1, 64, 3, device=cuda, dtype=torch.float64), 5)
