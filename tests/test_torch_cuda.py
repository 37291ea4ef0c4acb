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
kernel's own ids (the two sum the same f32 terms in another order),
bitwise equal across two runs (the backward uses no float atomics) and
bitwise equal to `knn_gather_backward_ordered` (slot 0, then ascending
entry id), also where one hub point holds every entry. The
single-chunk backward (value_chunks=1) truncates the slots >= 1 to bf16 as
the plain version does, with the same bars, at N from 1 to 2048, every k
and ids that repeat.

The small-C selection (the fused layer, knn_gather and the kNN) runs 128
query rows per block against 8 key lanes: its ids equal the plain
version's at every N around those blocks and the 2048-column windows, for
every k, on clouds with duplicate points and exact distance ties (the
lower column wins). The edge MLP runs on bf16 tensor cores with widths
padded to the MMA tile: widths off every multiple of 8 and 16, a 4-layer
MLP and the bf16 mode meet the output bars above.

The wide-D kNN ranks exact distances: ids at least 99% equal to the plain
version's, every disagreement two neighbours whose f64 distances agree
within 2^-18 of the squared norms. The chunked EdgeConv training layer on
the card against its CPU plain path from the same weights: output, running
statistics and the whole gradient within 1e-2 of their L2 norms, each
parameter's gradient within 5e-2 (the training phase's bars of
chip_smoke.py: near-tie ids and ReLU boundaries make gradients jumpy).

The fused layer is the registered operator `gpe_torch::fused_edgeconv`:
through it the kernel's outputs and ids are bitwise those of a direct
launch, and a serving artifact exported with `torch.export` on the card
launches the kernel once per layer and call, equals `build_serving_fn`
bitwise and refuses a CPU input.

Data parallelism (parallel/): every kernel launcher runs on its input's
card whatever the current device is (two cards); a world-1 NCCL group's
data-parallel step equals the same step without a group (loss 1e-5
relative, gradient 1e-5 of its norm; the same kernels on the same rows, the
collectives of one rank copy); R NCCL ranks, one card each, equal one
process on the padded batch with the same bars and pass
`dryrun_multichip(R)` (two cards or more).

Every shape the JAX package takes: the wide-D kNN past D = 256, knn_gather
past C = 256 (forward and backward), the fused layer with edge MLPs of 5
layers and up to 2048 wide (one launch where 5-8 slots of edge rows fit
shared memory, else a selection launch and an edge-MLP launch of 4, 2 or
1 slots a group), at C past 256 and at 128 < k <= N (the selection of all
N keys), with the bars above; the standalone kNN still raises above 128,
and a layer wider than 2048 is routed by EdgeConv to knn_gather.

The on-device sampling stage on the card against its CPU core with the
same draws: face ids equal except draws within 1e-6 of the total area of a
step of the cumulative areas, or within the two devices' own gap on the
steps (the card's scan rounds otherwise), points
within 1e-5 of the mesh extent where the ids agree, labels equal except
near ties.
"""
import copy
import json

import numpy as np
import pytest
import torch

from garment_pattern_estimation_torch.models.blocks import EdgeConv
from garment_pattern_estimation_torch.ops import edgeconv, knn, knn_gather, launches_by_variant

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
    (100, 150, 8, torch.float32),     # one ragged key tile, the widest k
    (10001, 150, 5, torch.float32),   # tiled wide C: ragged query block and key tile
    (2049, 256, 3, torch.float32),    # the widest C, depth 256
    (3000, 17, 7, torch.float32),     # the narrowest wide C, depth padded to 32
])
def test_kernel_matches_plain(cuda, rng, n_points, C, k, mlp_dtype):
    folded = _folded(rng, C, [200, 200, 150], cuda)
    x = torch.from_numpy(rng.normal(size=(2, n_points, C)).astype(np.float32)).to(cuda)
    before = launches_by_variant(edgeconv)
    out, idx = edgeconv.fused_edgeconv(x, folded, k=k, mlp_dtype=mlp_dtype,
                                       return_idx=True)
    torch.cuda.synchronize()
    variant = ('small_c' if C <= edgeconv.SMALL_C_MAX else 'wide_c') \
        + ('_tiled' if n_points > knn.MAX_N else '')
    assert launches_by_variant(edgeconv)[variant] == before[variant] + 1
    assert sum(launches_by_variant(edgeconv).values()) == sum(before.values()) + 1
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
    before = launches_by_variant(edgeconv)
    out, idx = edgeconv.fused_edgeconv(x, folded, k=5, return_idx=True)
    tiled_out, tiled_idx = edgeconv.fused_edgeconv(x, folded, k=5, return_idx=True,
                                                   tile_n=tile_n)
    torch.cuda.synchronize()
    variant = 'small_c' if C <= edgeconv.SMALL_C_MAX else 'wide_c'
    assert launches_by_variant(edgeconv)[variant] == before[variant] + 1
    assert launches_by_variant(edgeconv)[variant + '_tiled'] == before[variant + '_tiled'] + 1
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
    before = launches_by_variant(knn)['knn']
    ids = knn.knn(x, k, tile_n=tile_n)
    torch.cuda.synchronize()
    assert launches_by_variant(knn)['knn'] == before + 1
    assert torch.equal(ids, knn.knn_reference(x, k))


def test_knn_wrong_dtype_raises(cuda):
    with pytest.raises(TypeError):
        knn.knn(torch.zeros(1, 64, 3, device=cuda, dtype=torch.float64), 5)


def _sorted_dists64(x, ids):
    """f64 squared distances of each query to its ids, ascending."""
    x = x.double()
    B, N, k = ids.shape
    nbr = x[torch.arange(B, device=x.device)[:, None, None], ids]      # (B, N, k, D)
    return ((nbr - x[:, :, None]) ** 2).sum(-1).sort(dim=-1).values


@pytest.mark.parametrize('D', [17, 150, 256])
@pytest.mark.parametrize('n_points', [100, 2000, 10000])
@pytest.mark.parametrize('k', [1, 5, 8])
def test_knn_wide_matches_plain(cuda, rng, D, n_points, k):
    """Ids at least 99% equal to the plain version's; where they differ,
    the two neighbour lists' exact distances agree slot by slot within
    2^-18 of the squared norms (the kernel and cuBLAS sum in other
    orders)."""
    x = torch.from_numpy(rng.normal(size=(2, n_points, D)).astype(np.float32)).to(cuda)
    before = launches_by_variant(knn)
    ids = knn.knn(x, k)
    torch.cuda.synchronize()
    assert launches_by_variant(knn)['knn_wide'] == before['knn_wide'] + 1
    assert launches_by_variant(knn)['knn'] == before['knn']
    ref = knn.knn_reference(x, k)
    assert ids.dtype == torch.int64 and ids.shape == ref.shape
    assert torch.equal(ids[..., 0], ref[..., 0])
    assert (ids == ref).float().mean().item() >= 0.99
    rows = ~(ids == ref).all(dim=-1)
    if rows.any():
        norms = (x.double() ** 2).sum(-1)
        bound = 2.0 ** -18 * (norms + norms.amax(dim=-1, keepdim=True))[..., None]
        gap = (_sorted_dists64(x, ids) - _sorted_dists64(x, ref)).abs()
        assert (gap[rows] <= bound.expand_as(gap)[rows]).all()


def test_knn_wide_ties_and_duplicates(cuda, rng):
    """Integer coordinates make every product and sum exact: the ids equal
    the plain version's, ties to the lower index included."""
    x = torch.from_numpy(rng.integers(-2, 3, size=(2, 300, 24)).astype(np.float32))
    x[:, 150:] = x[:, :150]                                   # exact duplicates
    ids = knn.knn(x.to(cuda), 5)
    assert torch.equal(ids.cpu(), knn.knn_reference(x, 5))


@pytest.mark.parametrize('D', [17, 150, 256])
@pytest.mark.parametrize('n_points', [100, 2049, 10001])
def test_knn_wide_ragged_tiles(cuda, rng, D, n_points):
    """N off every multiple of the 64-query block and the 64-key tile, D
    padded to the 16-deep MMA steps: the bars of test_knn_wide_matches_plain."""
    test_knn_wide_matches_plain(cuda, rng, D, n_points, 6)


@pytest.mark.parametrize('k', range(1, 9))
def test_knn_wide_every_k(cuda, rng, k):
    test_knn_wide_matches_plain(cuda, rng, 150, 2049, k)


def test_knn_wide_near_duplicates(cuda, rng):
    """Each point's twin, 2^-20 of its scale away: q_norm + k_norm - 2 cross
    is rounding noise around 0, negative for some twins (the plain version
    shows that some exist), and the exact ranking still puts every twin in
    slot 1."""
    base = rng.normal(size=(2, 1000, 150)).astype(np.float32)
    twin = base * (1 + 2.0 ** -20 * rng.standard_normal(base.shape)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([base, twin], axis=1)).to(cuda)
    partner = (torch.arange(2000, device=cuda) + 1000) % 2000
    plain = knn.wide_sq_dists(x)
    assert (plain[:, torch.arange(2000, device=cuda), partner] < 0).any()
    ids = knn.knn(x, 5)
    ref = knn.knn_reference(x, 5)
    assert torch.equal(ids[..., :2], ref[..., :2])
    assert torch.equal(ids[..., 1], partner.expand(2, -1))
    # the farther neighbours come in twin pairs, whose order is a near tie
    assert (ids[..., 2:] % 1000 == ref[..., 2:] % 1000).float().mean().item() >= 0.99


def test_tiled_wide_c_at_stress_shape(cuda, rng):
    """Three clouds of the stress configuration's conv1, (3, 10000, 150) ->
    150 at the att widths, through the tiled wide-C variant: the bars of
    test_kernel_matches_plain."""
    folded = _folded(rng, 150, [200, 200, 150], cuda)
    x = torch.from_numpy(rng.normal(size=(3, 10000, 150)).astype(np.float32)).to(cuda)
    before = launches_by_variant(edgeconv)
    out, idx = edgeconv.fused_edgeconv(x, folded, k=5, return_idx=True)
    torch.cuda.synchronize()
    assert launches_by_variant(edgeconv)['wide_c_tiled'] == before['wide_c_tiled'] + 1
    ref_idx, x_lp = edgeconv.edgeconv_select(x, 5)
    assert (idx == ref_idx).float().mean().item() >= 0.99
    tail = edgeconv.edgeconv_mlp_max(x, idx, x_lp, folded)
    scale = tail.abs().max().item()
    diff = (out - tail).abs()
    assert diff.max().item() <= 1e-2 * scale and diff.mean().item() <= 1e-4 * scale


def test_knn_wide_wrong_dtype_raises(cuda):
    with pytest.raises(TypeError):
        knn.knn(torch.zeros(1, 64, 150, device=cuda, dtype=torch.float64), 5)


@pytest.mark.parametrize('D', [257, 300, 512])
@pytest.mark.parametrize('n_points,k', [(100, 5), (2000, 5), (2000, 20), (10000, 8), (300, 1)])
def test_knn_wide_past_256_matches_plain(cuda, rng, D, n_points, k):
    """D past 256, staged 256 features at a time: the bars of
    test_knn_wide_matches_plain."""
    test_knn_wide_matches_plain(cuda, rng, D, n_points, k)


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
    (100, 150, 8, 2),                 # one ragged key tile, the widest k
    (2048, 17, 2, 2),                 # the bound of N, depth padded to 32
])
def test_knn_gather_matches_plain(cuda, rng, n_points, C, k, value_chunks):
    x = torch.from_numpy(rng.normal(size=(2, n_points, C)).astype(np.float32)).to(cuda)
    x.requires_grad_(True)
    before = launches_by_variant(knn_gather)
    nbr, idx = knn_gather.knn_gather(x, k, value_chunks)
    g = torch.from_numpy(rng.normal(size=tuple(nbr.shape)).astype(np.float32)).to(cuda)
    (dx,) = torch.autograd.grad(nbr, x, g)
    torch.cuda.synchronize()
    variant = 'fwd_small_c' if C <= edgeconv.SMALL_C_MAX else 'fwd_wide_c'
    bwd = 'bwd' if value_chunks == 2 else 'bwd_hi'
    assert launches_by_variant(knn_gather)[variant] == before[variant] + 1
    assert launches_by_variant(knn_gather)[bwd] == before[bwd] + 1

    ref_nbr, ref_idx = knn_gather.knn_gather_reference(x.detach(), k, value_chunks)
    if C <= edgeconv.SMALL_C_MAX:
        assert torch.equal(idx, ref_idx)
    else:
        assert (idx == ref_idx).float().mean().item() >= 0.99
    agree = (idx == ref_idx).transpose(1, 2)                       # (B, k, N)
    assert torch.equal(nbr[agree], ref_nbr[agree])

    ref_dx = knn_gather.knn_gather_backward_reference(idx, g, value_chunks, torch.float64)
    scale = ref_dx.abs().max().item()
    assert (dx.double() - ref_dx).abs().max().item() <= 1e-5 * scale
    (dx_again,) = torch.autograd.grad(knn_gather.knn_gather(x, k, value_chunks)[0], x, g)
    assert torch.equal(dx, dx_again)


@pytest.mark.parametrize('n_points,k', [(n, k) for n in (1, 31, 33, 100, 2047, 2048)
                                        for k in range(1, 9) if k <= n])
def test_knn_gather_single_chunk_backward(cuda, rng, n_points, k):
    """value_chunks=1 on ids drawn from a quarter of the points (each
    target picked many times), C = 150, cotangents that are not bf16-valued:
    within 1e-5 of the plain version's largest magnitude, two runs bitwise
    equal, one 'bwd_hi' launch each."""
    B, C = 2, 150
    idx = torch.from_numpy(rng.integers(0, max(1, n_points // 4), size=(B, n_points, k)))
    idx[:, :, 0] = torch.arange(n_points)
    idx = idx.to(cuda)
    g = torch.from_numpy(rng.normal(size=(B, k, n_points, C)).astype(np.float32)).to(cuda)
    before = launches_by_variant(knn_gather)
    dx = knn_gather.knn_gather_bwd(idx, g, value_chunks=1)
    dx_again = knn_gather.knn_gather_bwd(idx, g, value_chunks=1)
    torch.cuda.synchronize()
    assert launches_by_variant(knn_gather)['bwd_hi'] == before['bwd_hi'] + 2
    assert launches_by_variant(knn_gather)['bwd'] == before['bwd']
    ref_dx = knn_gather.knn_gather_backward_reference(idx, g, value_chunks=1, dtype=torch.float64)
    scale = ref_dx.abs().max().item()
    assert (dx.double() - ref_dx).abs().max().item() <= 1e-5 * scale
    assert torch.equal(dx, dx_again)
    if k > 1:                             # the truncation is not a no-op here
        full = knn_gather.knn_gather_backward_reference(idx, g, value_chunks=2,
                                                        dtype=torch.float64)
        assert (full - ref_dx).abs().max().item() > 1e-5 * scale


@pytest.mark.parametrize('n_points,k,C,value_chunks', [
    (n, k, c, v) for n in (1, 31, 32, 33, 2048) for k in range(1, 9) if k <= n
    for c in (3, 24, 150, 256) for v in (1, 2)])
def test_knn_gather_backward_order(cuda, rng, n_points, k, C, value_chunks):
    """The backward kernels (CSR of the transposed graph, then one gathered
    sum per target) on ids drawn from all N points: bitwise equal to
    `knn_gather_backward_ordered` (slot 0, then ascending entry id: the
    summation order of the kernel they replaced), bitwise equal across two
    runs, and within 1e-5 of the plain version's largest magnitude."""
    B = 2
    idx = torch.from_numpy(rng.integers(0, n_points, size=(B, n_points, k)))
    idx[:, :, 0] = torch.arange(n_points)
    idx = idx.to(cuda)
    g = torch.from_numpy(rng.normal(size=(B, k, n_points, C)).astype(np.float32)).to(cuda)
    dx = knn_gather.knn_gather_bwd(idx, g, value_chunks)
    dx_again = knn_gather.knn_gather_bwd(idx, g, value_chunks)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx_again)
    assert torch.equal(dx, knn_gather.knn_gather_backward_ordered(idx, g, value_chunks))
    ref_dx = knn_gather.knn_gather_backward_reference(idx, g, value_chunks, torch.float64)
    assert (dx.double() - ref_dx).abs().max().item() <= 1e-5 * ref_dx.abs().max().item()


@pytest.mark.parametrize('n_points,k,C,value_chunks', [
    (33, 5, 150, 2), (33, 8, 3, 1), (2000, 5, 150, 2), (2000, 5, 150, 1),
    (2048, 8, 256, 2), (2048, 2, 24, 1)])
def test_knn_gather_backward_hub(cuda, rng, n_points, k, C, value_chunks):
    """Every query names one hub point in every slot >= 1, so the hub's list
    holds all N (k-1) entries and every other list is empty: the kernels
    equal the ordered sum bitwise and the plain version within 1e-5."""
    B, hub = 2, n_points // 3
    idx = torch.full((B, n_points, k), hub, dtype=torch.int64)
    idx[:, :, 0] = torch.arange(n_points)
    idx = idx.to(cuda)
    g = torch.from_numpy(rng.normal(size=(B, k, n_points, C)).astype(np.float32)).to(cuda)
    dx = knn_gather.knn_gather_bwd(idx, g, value_chunks)
    torch.cuda.synchronize()
    assert torch.equal(dx, knn_gather.knn_gather_backward_ordered(idx, g, value_chunks))
    ref_dx = knn_gather.knn_gather_backward_reference(idx, g, value_chunks, torch.float64)
    assert (dx.double() - ref_dx).abs().max().item() <= 1e-5 * ref_dx.abs().max().item()


def test_knn_gather_backward_scratch(cuda):
    """The library's backward takes a scratch of the size it asks for and
    refuses one byte less (cudaErrorInvalidValue, no launch)."""
    B, N, k, C = 2, 100, 5, 24
    idx = torch.randint(0, N, (B, N, k), device=cuda, dtype=torch.int32)
    g = torch.randn(B, k, N, C, device=cuda)
    dx = torch.zeros(B, N, C, device=cuda)
    lib = knn_gather._library()
    need = lib.knn_gather_bwd_scratch_bytes(B, N, k)
    assert need == B * (N + 1) * 4 + B * N * (k - 1) * 4
    scratch = torch.empty(need, device=cuda, dtype=torch.uint8)
    stream = torch.cuda.current_stream(cuda).cuda_stream

    def run(size):
        return lib.knn_gather_backward(idx.data_ptr(), g.data_ptr(), dx.data_ptr(),
                                       scratch.data_ptr(), size, B, N, C, k, 2, stream)
    assert run(need - 1) == 1
    torch.cuda.synchronize()
    assert not dx.any()
    assert run(need) == 0
    torch.cuda.synchronize()
    assert torch.equal(dx, knn_gather.knn_gather_bwd(idx, g, 2))


def _check_small_c_entries(cuda, x, k, folded):
    """The small-C fused layer, kNN and (N <= 2048) knn_gather on x: ids
    exactly the plain version's, fused output within the bars of
    test_kernel_matches_plain."""
    B, N, C = x.shape
    ref = knn.knn_reference(x, k)
    assert torch.equal(knn.knn(x, k), ref)
    out, idx = edgeconv.fused_edgeconv(x, folded, k=k, return_idx=True)
    torch.cuda.synchronize()
    assert torch.equal(idx, ref)
    ref_idx, x_lp = edgeconv.edgeconv_select(x, k)
    assert torch.equal(ref_idx, ref)
    tail = edgeconv.edgeconv_mlp_max(x, idx, x_lp, folded)
    scale = tail.abs().max().item()
    diff = (out - tail).abs()
    assert diff.max().item() <= 1e-2 * scale and diff.mean().item() <= 1e-4 * scale
    if N <= knn.MAX_N:
        nbr, gather_idx = knn_gather.knn_gather(x, min(k, N))
        assert torch.equal(gather_idx, ref)
        ref_nbr, _ = knn_gather.knn_gather_reference(x, min(k, N))
        assert torch.equal(nbr, ref_nbr)


@pytest.mark.parametrize('n_points', [1, 15, 17, 2047, 2049, 10001])
@pytest.mark.parametrize('k', range(1, 9))
def test_small_c_ids_every_n_and_k(cuda, rng, n_points, k):
    """N around the 128-row query blocks, the 8 key lanes and the 2048-column
    key windows, every k: ids exactly the plain version's."""
    folded = _folded(rng, 3, [32, 24], cuda)
    clouds = 1 if n_points > 2048 else 2
    x = torch.from_numpy(rng.normal(size=(clouds, n_points, 3)).astype(np.float32)).to(cuda)
    _check_small_c_entries(cuda, x, k, folded)


@pytest.mark.parametrize('C', [1, 2, 4, 8, 16])
@pytest.mark.parametrize('n_points', [300, 3000])
def test_small_c_ids_every_width(cuda, rng, C, n_points):
    """The 3-dimension and the 16-dimension instantiations, C padded with
    zero dimensions: ids exactly the plain version's."""
    folded = _folded(rng, C, [32, 24], cuda)
    x = torch.from_numpy(rng.normal(size=(2, n_points, C)).astype(np.float32)).to(cuda)
    _check_small_c_entries(cuda, x, 5, folded)


@pytest.mark.parametrize('n_points,C,tile_n', [(600, 3, None), (3000, 3, None),
                                                (3000, 3, 300), (2000, 8, None)])
def test_small_c_duplicates_and_ties(cuda, rng, n_points, C, tile_n):
    """Integer lattice clouds, every point twice: many exact distance ties
    (0 between twins); the lower column wins, as in the plain version."""
    half = rng.integers(-3, 4, size=(2, n_points // 2, C)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([half, half], axis=1)).to(cuda)
    folded = _folded(rng, C, [32, 24], cuda)
    for k in (2, 5, 8):
        ref = knn.knn_reference(x, k)
        assert torch.equal(knn.knn(x, k, tile_n=tile_n), ref)
        _, idx = edgeconv.fused_edgeconv(x, folded, k=k, return_idx=True, tile_n=tile_n)
        assert torch.equal(idx, ref)
        if n_points <= knn.MAX_N:
            assert torch.equal(knn_gather.knn_gather(x, k)[1], ref)


@pytest.mark.parametrize('C,widths,mlp_dtype,n_points', [
    (3, [24, 40, 17], torch.float32, 500),      # widths off the 8- and 16-column tiles
    (24, [24, 40, 17], torch.float32, 500),
    (3, [64, 48, 40, 8], torch.float32, 3000),  # four layers, tiled
    (150, [200, 200, 150], torch.bfloat16, 700),
    (24, [256, 256, 200, 256], torch.float32, 300),   # the widest layers
    (3, [16], torch.float32, 2049),             # one layer
])
def test_edge_mlp_widths(cuda, rng, C, widths, mlp_dtype, n_points):
    """The tensor-core edge MLP at other widths and depths: the bars of
    test_kernel_matches_plain on the kernel's own ids."""
    folded = _folded(rng, C, widths, cuda)
    x = torch.from_numpy(rng.normal(size=(2, n_points, C)).astype(np.float32)).to(cuda)
    for k in (1, 5, 8):
        out, idx = edgeconv.fused_edgeconv(x, folded, k=k, mlp_dtype=mlp_dtype,
                                           return_idx=True)
        assert out.shape == (2, n_points, widths[-1])
        _, x_lp = edgeconv.edgeconv_select(x, k, mlp_dtype)
        tail = edgeconv.edgeconv_mlp_max(x, idx, x_lp, folded)
        scale = tail.abs().max().item()
        diff = (out - tail).abs()
        assert diff.max().item() <= 1e-2 * scale and diff.mean().item() <= 1e-4 * scale


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


def _rel_l2(ours, ref):
    return ((ours.cpu() - ref).norm() / ref.norm()).item()


@pytest.mark.parametrize('C', [3, 150])
def test_chunked_edgeconv_layer_matches_cpu(cuda, rng, C):
    """The att widths at 2000 points in chunks of 700 (the last one padded):
    conv0 on the small-D kNN kernel, conv1 on the wide-D one."""
    layer = EdgeConv(C, [200, 200, 150], k=5, train_chunked=True, train_chunk_size=700)
    with torch.no_grad():
        for _, _, bn in layer.nn:
            signs = torch.from_numpy(np.where(np.arange(bn.weight.numel()) % 2, -1.0, 1.0))
            bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, bn.weight.numel())) * signs)
            bn.bias.copy_(torch.from_numpy(rng.normal(size=bn.bias.numel())))
    x = torch.from_numpy(rng.normal(size=(2, 2000, C)).astype(np.float32))

    def run(device):
        conv = copy.deepcopy(layer).to(device).train()
        xd = x.to(device, copy=True).requires_grad_(True)
        out = conv(xd)
        (out ** 2).mean().backward()
        grads = {n: p.grad.cpu() for n, p in conv.named_parameters()}
        grads['x'] = xd.grad.cpu()
        stats = {n: b.cpu() for n, b in conv.named_buffers() if 'running' in n}
        return out.detach().cpu(), stats, grads

    before = launches_by_variant(knn)
    out, stats, grads = run(cuda)
    torch.cuda.synchronize()
    variant = 'knn' if C <= 16 else 'knn_wide'
    assert launches_by_variant(knn)[variant] == before[variant] + 1
    assert sum(launches_by_variant(knn).values()) == sum(before.values()) + 1
    ref_out, ref_stats, ref_grads = run('cpu')
    assert _rel_l2(out, ref_out) <= 1e-2
    for name, value in ref_stats.items():
        assert _rel_l2(stats[name], value) <= 1e-2, name
    whole = sum(((grads[n] - g) ** 2).sum() for n, g in ref_grads.items()).sqrt() \
        / sum((g ** 2).sum() for g in ref_grads.values()).sqrt()
    assert whole.item() <= 1e-2
    for name, g in ref_grads.items():
        assert _rel_l2(grads[name], g) <= 5e-2, name


@pytest.mark.parametrize('C', [3, 24])
@pytest.mark.parametrize('train,n_points', [(False, 16400), (True, 3000)])
def test_unfused_edgeconv_matches_cpu(cuda, rng, C, train, n_points):
    """Past the fused bound in eval and past 2048 points unchunked in train:
    the standalone kNN kernel of C, the gather and the edge MLP, against the
    CPU plain path (output within 1e-2 of its L2 norm; in train, the whole
    gradient likewise)."""
    layer = EdgeConv(C, [16, 12], k=5)
    with torch.no_grad():
        for _, _, bn in layer.nn:
            bn.running_mean.copy_(torch.from_numpy(rng.normal(size=bn.running_mean.numel())))
            bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, bn.running_var.numel())))
    x = torch.from_numpy(rng.normal(size=(1, n_points, C)).astype(np.float32))

    def run(device):
        conv = copy.deepcopy(layer).to(device).train(train)
        xd = x.to(device, copy=True).requires_grad_(train)
        out = conv(xd)
        if not train:
            return out.detach().cpu(), None
        (out ** 2).mean().backward()
        return out.detach().cpu(), torch.cat([xd.grad.flatten()] + [
            p.grad.flatten() for p in conv.parameters()]).cpu()

    assert train or not edgeconv.fused_edgeconv_supported(n_points, C)
    assert not layer.chunked(1, n_points, C)
    before = launches_by_variant(knn)
    out, grads = run(cuda)
    torch.cuda.synchronize()
    variant = 'knn' if C <= 16 else 'knn_wide'
    assert launches_by_variant(knn)[variant] == before[variant] + 1
    ref_out, ref_grads = run('cpu')
    assert _rel_l2(out, ref_out) <= 1e-2
    if train:
        assert _rel_l2(grads, ref_grads) <= 1e-2


def _tied_pattern_inputs(rng, B=4, P=23, L=14):
    """The baseline loss's matching inputs at lstm_stitch_tags.yaml's shapes,
    with exact ties: padded GT panels (equal features, zero edges), a
    panel whose edges are all equal, panels of 1 and 2 edges; predictions
    are the GT in another panel order, loops rotated, plus noise."""
    num_panels = np.array([P, 9, 3, 14])[:B]
    num_edges = np.where(np.arange(P)[None] < num_panels[:, None],
                         rng.integers(3, L + 1, size=(B, P)), 0)
    num_edges[1, 2], num_edges[1, 5] = 1, 2
    outlines = rng.normal(size=(B, P, L, 4)).astype(np.float32)
    outlines[0, 4] = outlines[0, 4, 0]
    outlines = np.where((np.arange(L)[None, None] < num_edges[..., None])[..., None],
                        outlines, -0.5).astype(np.float32)
    features = np.concatenate([np.where((num_edges > 0)[..., None],
                                        rng.normal(size=(B, P, 3)), 0.0),
                               outlines.reshape(B, P, -1)], -1).astype(np.float32)
    perm = np.stack([rng.permutation(P) for _ in range(B)])
    pred_outlines = np.roll(np.take_along_axis(outlines, perm[..., None, None], 1), 3, axis=2)
    pred_features = np.take_along_axis(features, perm[..., None], 1)
    noise = lambda a: (a + 0.05 * rng.normal(size=a.shape)).astype(np.float32)
    return (torch.from_numpy(noise(pred_features)), torch.from_numpy(features),
            torch.from_numpy(noise(pred_outlines)), torch.from_numpy(outlines),
            torch.from_numpy(num_edges))


def test_greedy_order_match_matches_cpu(cuda, rng):
    """The same permutation on the card: the first of equal minima, up to
    two slots as close as f32 rounding to identical padded panels, which
    then take them in either order (the permuted GT is the same)."""
    from garment_pattern_estimation_torch.losses import composed

    pred_f, gt_f, _, _, num_edges = _tied_pattern_inputs(rng)
    on_card = composed.greedy_order_match(pred_f.to(cuda), gt_f.to(cuda)).cpu()
    on_cpu = composed.greedy_order_match(pred_f, gt_f)
    differ = on_card != on_cpu
    padded = num_edges == 0
    assert padded.gather(1, on_card)[differ].all() and padded.gather(1, on_cpu)[differ].all()
    assert torch.equal(composed.permute_panels(gt_f, on_card),
                       composed.permute_panels(gt_f, on_cpu))
    flat = torch.zeros(2, 23, 5, device=cuda)              # every distance ties
    assert torch.equal(composed.greedy_order_match(flat, flat).cpu(),
                       torch.arange(23).repeat(2, 1))


def test_match_panel_origins_matches_cpu(cuda, rng):
    from garment_pattern_estimation_torch.losses import composed

    _, _, pred_outlines, outlines, num_edges = _tied_pattern_inputs(rng)
    card_out, card_lead = composed.match_panel_origins(
        pred_outlines.to(cuda), outlines.to(cuda), num_edges.to(cuda))
    cpu_out, cpu_lead = composed.match_panel_origins(pred_outlines, outlines, num_edges)
    assert torch.equal(card_lead.cpu(), cpu_lead)
    assert torch.equal(card_out.cpu(), cpu_out)
    assert card_lead.reshape(4, 23)[0, 4] == 0 and not card_lead.reshape(4, 23)[1, 9:].any()


def test_tags_to_stitches_matches_cpu(cuda, rng):
    """Identical tags (zero distances) and an odd count of non-free edges:
    the same pairs, in the same order, on the card."""
    from garment_pattern_estimation_torch.losses import stitches

    B, E = 4, 23 * 14
    tags = torch.from_numpy(rng.normal(size=(B, 23, 14, 3)).astype(np.float32))
    tags.view(B, E, 3)[:, :9] = tags.view(B, E, 3)[:, :1]
    scores = torch.from_numpy(rng.normal(size=(B, 23, 14)).astype(np.float32))
    scores.view(B, E)[:, :9] = -1.0
    card = stitches.tags_to_stitches_jit(tags.to(cuda), scores.to(cuda), E // 2)
    cpu = stitches.tags_to_stitches_jit(tags, scores, E // 2)
    assert torch.equal(card[0].cpu(), cpu[0]) and torch.equal(card[1].cpu(), cpu[1])
    assert cpu[1].any()


def test_full_model_eval_matches_cpu(cuda):
    """configs/lstm_stitch_tags.yaml's model (seeded weights) served on the
    card against its CPU plain path: each output within 1e-2 of its largest
    magnitude (chip_smoke.py's serving bar)."""
    from garment_pattern_estimation_torch.experiment import build_serving_fn
    from garment_pattern_estimation_torch.models import build_model

    data = {'element_size': 4, 'rotation_size': 4, 'translation_size': 3,
            'max_panel_len': 14, 'max_pattern_len': 23}
    nn_config = {'model': 'GarmentFullPattern3D', 'EConv_hidden': 200, 'EConv_feature': 150,
                 'EConv_hidden_depth': 2, 'k_neighbors': 5, 'conv_depth': 2,
                 'skip_connections': True, 'global_pool': 'mean', 'panel_encoding_size': 250,
                 'panel_hidden_size': 250, 'panel_n_layers': 3, 'pattern_encoding_size': 250,
                 'pattern_hidden_size': 250, 'pattern_n_layers': 2,
                 'lstm_init': 'kaiming_normal_'}
    model = build_model('GarmentFullPattern3D', data, nn_config, device=cuda)
    cpu_model = copy.copy(model)
    cpu_model.module = copy.deepcopy(model.module).cpu()
    x = torch.randn(2, 2000, 3, generator=torch.Generator().manual_seed(9))
    before = launches_by_variant(edgeconv)
    on_card = build_serving_fn(model, data)(x.to(cuda))
    on_cpu = build_serving_fn(cpu_model, data)(x)
    assert launches_by_variant(edgeconv)['small_c'] == before['small_c'] + 1
    assert launches_by_variant(edgeconv)['wide_c'] == before['wide_c'] + 1
    for key, ref in on_cpu.items():
        scale = ref.abs().max().item()
        assert (on_card[key].cpu() - ref).abs().max().item() <= 1e-2 * scale, key


def _stitch_models(cuda):
    """configs/stitch_model.yaml's model (16 -> 200 x 3 -> 1, seeded weights)
    on the card and the same weights on the CPU."""
    from garment_pattern_estimation_torch.models import build_model

    nn_config = {'stitch_hidden_size': 200, 'stitch_mlp_n_layers': 3}
    model = build_model('StitchOnEdge3DPairs', {'element_size': 16}, nn_config, device=cuda)
    cpu_model = copy.copy(model)
    cpu_model.module = copy.deepcopy(model.module).cpu()
    return model, cpu_model


def test_stitch_model_forward_matches_cpu(cuda, rng):
    """The stitch model's eval and train forwards on a (30, 400, 16) batch,
    the published batch of pairs: logits within 1e-5 of their largest
    magnitude of the CPU plain path's (f32 products, TF32 off), and the
    running statistics within 1e-5 of theirs."""
    model, cpu_model = _stitch_models(cuda)
    x = torch.from_numpy(rng.normal(size=(30, 400, 16)).astype(np.float32))
    for train in (False, True):
        model.module.train(train)
        cpu_model.module.train(train)
        with torch.no_grad():
            on_card = model.module(x.to(cuda)).cpu()
            on_cpu = cpu_model.module(x)
        assert on_card.shape == (30, 400)
        assert (on_card - on_cpu).abs().max().item() <= 1e-5 * on_cpu.abs().max().item()
    cpu_state = cpu_model.module.state_dict()
    for name, value in model.module.state_dict().items():
        if 'running' in name:
            ref = cpu_state[name]
            assert (value.cpu() - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_stitch_train_step_matches_cpu(cuda, rng):
    """One Trainer.train_step (stitch_model.yaml's Adam and one-cycle) on 4
    garments x 400 pairs on the card against the CPU plain path: the loss
    within 1e-5 relative, the gradient within 1e-4 of its norm
    (chip_smoke.py's stitch_pipeline bars), the loss's metrics equal."""
    from garment_pattern_estimation_torch.train import Trainer

    setup = {'batch_size': 4, 'epochs': 2, 'learning_rate': 0.002, 'optimizer': 'Adam',
             'weight_decay': 0, 'lr_scheduling': {'mode': '1cyclic'}}
    batch = {'features': torch.from_numpy(rng.normal(size=(4, 400, 16)).astype(np.float32)),
             'ground_truth': torch.from_numpy(rng.integers(0, 2, size=(4, 400)).astype(bool))}
    results = []
    for m, device in zip(_stitch_models(cuda), (cuda, 'cpu')):
        trainer = Trainer(setup, device=device)
        trainer.make_optimizer(m, 3)
        loss, terms = trainer.train_step(m, batch, 0)
        grads = torch.cat([p.grad.detach().cpu().reshape(-1) for p in m.module.parameters()])
        results.append((loss.item(), {k: v.item() for k, v in terms.items()}, grads))
    (card_loss, card_terms, card_grads), (cpu_loss, cpu_terms, cpu_grads) = results
    assert abs(card_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    assert (card_grads - cpu_grads).norm().item() <= 1e-4 * cpu_grads.norm().item()
    for key in ('edge_pair_class_acc', 'stitch_precision', 'stitch_recall'):
        assert abs(card_terms[key] - cpu_terms[key]) <= 1e-6, key


def test_stitch_bucketed_prediction_equals_unpadded(cuda, rng):
    """make_predict_fn(bucket_pairs=True) on the card: pair counts padded to
    their power-of-two bucket give the unpadded forward's logits within
    1e-6 of their scale."""
    from garment_pattern_estimation_torch.train import make_predict_fn

    model, _ = _stitch_models(cuda)
    predict = make_predict_fn(model, bucket_pairs=True)
    for n in (7, 148, 392, 513):
        pairs = rng.normal(size=(n, 16)).astype(np.float32)
        bucketed = predict(pairs)
        with torch.no_grad():
            plain = model.module.eval()(torch.from_numpy(pairs).to(cuda)).cpu().numpy()
        assert bucketed.shape == (n,)
        assert np.abs(bucketed - plain).max() <= 1e-6 * max(1.0, np.abs(plain).max())


@pytest.mark.parametrize('C', [3, 150])
@pytest.mark.parametrize('mlp_dtype', [torch.float32, torch.bfloat16])
def test_operator_equals_direct_launch(cuda, rng, C, mlp_dtype):
    """`fused_edgeconv` through the registered operator against a direct
    launch of the kernel (`_launch`) at the attention model's shapes
    (64, 2000, C) -> 150: bitwise equal outputs and ids, one launch each."""
    folded = _folded(rng, C, [200, 200, 150], cuda)
    x = torch.from_numpy(rng.normal(size=(64, 2000, C)).astype(np.float32)).to(cuda)
    variant = 'small_c' if C <= edgeconv.SMALL_C_MAX else 'wide_c'
    before = launches_by_variant(edgeconv)[variant]
    out, idx = edgeconv.fused_edgeconv(x, folded, k=5, mlp_dtype=mlp_dtype, return_idx=True)
    direct, direct_idx = edgeconv._launch(x, folded, 5, mlp_dtype, True, None)
    plain_out = edgeconv.fused_edgeconv(x, folded, k=5, mlp_dtype=mlp_dtype)
    torch.cuda.synchronize()
    assert launches_by_variant(edgeconv)[variant] == before + 3
    assert torch.equal(out, direct) and torch.equal(idx, direct_idx)
    assert torch.equal(plain_out, direct)
    assert idx.dtype == torch.int64 and out.dtype == torch.float32


def _served_att(cuda, data, compute_dtype=None):
    from garment_pattern_estimation_torch.models import build_model

    nn_config = {'EConv_hidden': 200, 'EConv_feature': 150, 'EConv_hidden_depth': 2,
                 'k_neighbors': 5, 'conv_depth': 2, 'skip_connections': True,
                 'global_pool': 'mean', 'local_attention': True, 'panel_encoding_size': 250,
                 'panel_hidden_size': 250, 'panel_n_layers': 3, 'compute_dtype': compute_dtype}
    return build_model('GarmentSegmentPattern3D', data, nn_config, device=cuda, seed=3)


@pytest.mark.parametrize('compute_dtype', [None, 'bfloat16'])
def test_exported_artifact_on_the_card(cuda, tmp_path, compute_dtype):
    """An artifact exported on the card reloads, launches the kernel through
    the operator (one launch per layer and call), equals `build_serving_fn`
    bitwise, and refuses a CPU input."""
    from garment_pattern_estimation_torch.experiment import (
        build_serving_fn, export_serving_artifact, load_serving_artifact)

    data = {'element_size': 4, 'rotation_size': 4, 'translation_size': 3,
            'max_panel_len': 14, 'max_pattern_len': 23,
            'standardize': {'f_shift': [0.1, -2.0, 0.5], 'f_scale': [3.0, 5.0, 2.0],
                            'gt_shift': {'translations': [-55.0, -20.0, -17.0]},
                            'gt_scale': {'translations': [109.0, 98.0, 37.0]}}}
    model = _served_att(cuda, data, compute_dtype)
    manifest = export_serving_artifact(model, data, tmp_path, batch_size=4, num_points=2000)
    assert manifest['platforms'] == ['cuda']
    served = load_serving_artifact(tmp_path)
    x = torch.randn(4, 2000, 3, generator=torch.Generator().manual_seed(5)) * 10.0
    before = launches_by_variant(edgeconv)
    out = served(x.to(cuda))
    torch.cuda.synchronize()
    assert launches_by_variant(edgeconv)['small_c'] == before['small_c'] + 1
    assert launches_by_variant(edgeconv)['wide_c'] == before['wide_c'] + 1
    ref = build_serving_fn(model, data)(x.to(cuda))
    assert sorted(out) == sorted(ref)
    for key in ref:
        assert out[key].device.type == 'cuda'
        assert torch.equal(out[key], ref[key]), key
    with pytest.raises(ValueError, match='exported for'):
        served(x)


# ---- k above 8: one K = 16 instance serves k = 9..16 ----

@pytest.mark.parametrize('k', [10, 16])
@pytest.mark.parametrize('n_points,C,widths', [
    (2000, 3, [64, 64, 32]),          # pool10's conv1
    (200, 32, [128] * 3),             # conv2 on pool1's 200 points
    (20, 128, [256] * 3),             # conv3 on pool2's 20 points, the widest MLP
    (3000, 3, [200, 200, 150]),       # the column-tiled variants
    (2049, 150, [200, 200, 150]),
])
def test_kernel_above_k8_matches_plain(cuda, rng, k, n_points, C, widths):
    """The fused layer at k = 10 and 16 (the edge MLP in two groups of 8
    slots, the slots past k repeating the query): small-C ids exactly the
    plain version's, wide ids at least 99%, outputs within 1e-2 of the
    plain tail's scale, 1e-4 on average."""
    folded = _folded(rng, C, widths, cuda)
    x = torch.from_numpy(rng.normal(size=(2, n_points, C)).astype(np.float32)).to(cuda)
    for mlp_dtype in (torch.float32, torch.bfloat16):
        out, idx = edgeconv.fused_edgeconv(x, folded, k=k, mlp_dtype=mlp_dtype,
                                           return_idx=True)
        torch.cuda.synchronize()
        assert idx.shape == (2, n_points, min(k, n_points))
        ref_idx, x_lp = edgeconv.edgeconv_select(x, k, mlp_dtype)
        if C <= edgeconv.SMALL_C_MAX:
            assert torch.equal(idx, ref_idx)
        else:
            assert (idx == ref_idx).float().mean().item() >= 0.99
        tail = edgeconv.edgeconv_mlp_max(x, idx, x_lp, folded).cpu().numpy()
        scale = float(np.abs(tail).max())
        diff = np.abs(out.cpu().numpy() - tail)
        assert diff.max() <= 1e-2 * scale and diff.mean() <= 1e-4 * scale


@pytest.mark.parametrize('k', [9, 10, 16])
@pytest.mark.parametrize('n_points', [16, 2000, 10000, 17000])
def test_small_c_above_k8_every_entry(cuda, rng, k, n_points):
    """The small-C selection's K = 16 instance in the fused layer, the kNN
    (int32 lists to 16384 points, int64 beyond) and knn_gather: ids exactly
    the plain version's; at 16 points k = 16 takes every point."""
    folded = _folded(rng, 3, [32, 24], cuda)
    clouds = 1 if n_points > 2048 else 2
    x = torch.from_numpy(rng.normal(size=(clouds, n_points, 3)).astype(np.float32)).to(cuda)
    if n_points > edgeconv.MAX_FUSED_N:
        assert torch.equal(knn.knn(x, k), knn.knn_reference(x, k))
    else:
        _check_small_c_entries(cuda, x, k, folded)


@pytest.mark.parametrize('k', [10, 16])
@pytest.mark.parametrize('D,n_points', [(32, 2000), (128, 200), (150, 10000)])
def test_knn_wide_above_k8_matches_plain(cuda, rng, k, D, n_points):
    test_knn_wide_matches_plain(cuda, rng, D, n_points, k)


@pytest.mark.parametrize('k', [10, 16])
@pytest.mark.parametrize('n_points,C,value_chunks', [
    (2000, 3, 2), (200, 32, 2), (200, 32, 1), (20, 128, 2), (2048, 150, 2)])
def test_knn_gather_above_k8_matches_plain(cuda, rng, k, n_points, C, value_chunks):
    """Forward and backward at k = 10 and 16; past N (k-1) = 14,336 entries
    (2000 points at k 10) the CSR lists are filled in the scratch."""
    test_knn_gather_matches_plain(cuda, rng, n_points, C, min(k, n_points), value_chunks)


@pytest.mark.parametrize('n_points,k,C,value_chunks', [
    (n, k, c, v) for n in (17, 2000, 2048) for k in (9, 10, 16) for c in (3, 150)
    for v in (1, 2)])
def test_knn_gather_backward_order_above_k8(cuda, rng, n_points, k, C, value_chunks):
    test_knn_gather_backward_order(cuda, rng, n_points, k, C, value_chunks)


@pytest.mark.parametrize('n_points,k', [(2000, 10), (2048, 16)])
def test_knn_gather_backward_hub_above_k8(cuda, rng, n_points, k):
    test_knn_gather_backward_hub(cuda, rng, n_points, k, 24, 2)


def test_k_above_16_raises(cuda, rng):
    """k = 129 is past the kNN kernels (their capacity instances end at 128,
    as the JAX package's knn_pallas): NotImplementedError naming the cap.
    The fused layer and knn_gather take it (the selection of all N keys)."""
    folded = _folded(rng, 3, [8, 8], cuda)
    small = torch.randn(1, 200, 3, device=cuda)
    wide = torch.randn(1, 200, 32, device=cuda)
    with pytest.raises(NotImplementedError, match='128'):
        knn.knn(small, 129)
    with pytest.raises(NotImplementedError, match='128'):
        knn.knn(wide, 129)
    assert edgeconv.fused_edgeconv(small, folded, k=129).shape == (1, 200, 8)
    nbr, idx = knn_gather.knn_gather_fwd(small, 129)
    assert nbr.shape == (1, 129, 200, 3) and idx.shape == (1, 200, 129)
    assert knn_gather.knn_gather_bwd(idx, torch.zeros(1, 129, 200, 3, device=cuda)).shape \
        == (1, 200, 3)


# ---- k above 16: the capacity instances K = 32, 64, 128 ----

K_RANGE = (17, 20, 32, 64, 128)


@pytest.mark.parametrize('k', K_RANGE)
@pytest.mark.parametrize('n_points,C,widths', [
    (2000, 3, [200, 200, 150]),       # row 4: the att conv0 at k = 20
    (2000, 150, [200, 200, 150]),     # row 5: conv1
    (3000, 3, [64, 32]),              # row 6: the column-tiled small C
    (2500, 150, [64, 32]),            # row 7: the streamed wide C
    (130, 24, [24, 16]),              # ragged query blocks, k near N
    (2049, 256, [32, 16]),            # the widest C
])
def test_kernel_above_k16_matches_plain(cuda, rng, k, n_points, C, widths):
    """The fused layer at k = 17..128: small-C ids exactly the plain
    version's, wide ids at least 99% and every disagreement a near tie of
    the quantized distances, outputs within 1e-2 of the plain tail's scale
    (1e-4 on average), f32 and bf16 MLP, one launch per call."""
    folded = _folded(rng, C, widths, cuda)
    x = torch.from_numpy(rng.normal(size=(2, n_points, C)).astype(np.float32)).to(cuda)
    for mlp_dtype in (torch.float32, torch.bfloat16):
        before = sum(launches_by_variant(edgeconv).values())
        out, idx = edgeconv.fused_edgeconv(x, folded, k=k, mlp_dtype=mlp_dtype,
                                           return_idx=True)
        torch.cuda.synchronize()
        assert sum(launches_by_variant(edgeconv).values()) == before + 1
        assert idx.shape == (2, n_points, min(k, n_points))
        ref_idx, x_lp = edgeconv.edgeconv_select(x, k, mlp_dtype)
        assert torch.equal(idx[..., 0], ref_idx[..., 0])
        if C <= edgeconv.SMALL_C_MAX:
            assert torch.equal(idx, ref_idx)
        else:
            assert (idx == ref_idx).float().mean().item() >= 0.99
        tail = edgeconv.edgeconv_mlp_max(x, idx, x_lp, folded).cpu().numpy()
        scale = float(np.abs(tail).max())
        diff = np.abs(out.cpu().numpy() - tail)
        assert diff.max() <= 1e-2 * scale and diff.mean() <= 1e-4 * scale


@pytest.mark.parametrize('k', K_RANGE)
@pytest.mark.parametrize('shape', [(2, 5000, 3), (2, 300, 16), (1, 16385, 3), (3, 129, 8)])
def test_knn_above_k16_matches_plain(cuda, rng, k, shape):
    """Row 1 at k = 17..128: ids exactly the plain version's."""
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(cuda)
    before = launches_by_variant(knn)['knn']
    ids = knn.knn(x, k)
    torch.cuda.synchronize()
    assert launches_by_variant(knn)['knn'] == before + 1
    assert torch.equal(ids, knn.knn_reference(x, k))


@pytest.mark.parametrize('k', K_RANGE)
@pytest.mark.parametrize('D,n_points', [(150, 2000), (32, 300), (256, 2049), (150, 10000)])
def test_knn_wide_above_k16_matches_plain(cuda, rng, k, D, n_points):
    """Rows 2-3 at k = 17..128: the bars of test_knn_wide_matches_plain."""
    test_knn_wide_matches_plain(cuda, rng, D, n_points, k)


@pytest.mark.parametrize('k', K_RANGE)
def test_small_c_above_k16_duplicates_and_ties(cuda, rng, k):
    """Integer coordinates with duplicate points: every distance ties with
    many others, and the lower column must win in the fused layer, the kNN
    and knn_gather alike."""
    x = torch.from_numpy(rng.integers(-3, 4, size=(2, 600, 3)).astype(np.float32))
    x[:, 300:] = x[:, :300]
    x = x.to(cuda)
    folded = _folded(rng, 3, [16, 8], cuda)
    _check_small_c_entries(cuda, x, k, folded)


@pytest.mark.parametrize('k', K_RANGE)
@pytest.mark.parametrize('n_points,C,value_chunks', [
    (2000, 3, 2), (2000, 150, 2), (2000, 150, 1), (300, 32, 2), (2048, 256, 2)])
def test_knn_gather_above_k16_matches_plain(cuda, rng, k, n_points, C, value_chunks):
    """Rows 8-9 at k = 17..128: forward ids and rows, backward dx within
    1e-5 of the f64 plain version, two runs bitwise equal."""
    test_knn_gather_matches_plain(cuda, rng, n_points, C, k, value_chunks)


@pytest.mark.parametrize('n_points,k,C,value_chunks', [
    (n, k, c, v) for n in (129, 2048) for k in K_RANGE for c in (3, 150) for v in (1, 2)])
def test_knn_gather_backward_order_above_k16(cuda, rng, n_points, k, C, value_chunks):
    test_knn_gather_backward_order(cuda, rng, n_points, k, C, value_chunks)


@pytest.mark.parametrize('n_points,k,C,value_bar', [
    (2000, 20, 150, 1e-5), (2048, 128, 24, 1e-4), (2048, 64, 256, 1e-4)])
def test_knn_gather_backward_hub_above_k16(cuda, rng, n_points, k, C, value_bar):
    """A hub holding all N (k-1) entries: 260,096 at N = 2048, k = 128,
    past any 16-bit count. The kernels equal the ordered sum bitwise. That
    f32 sum of 129,024 or 260,096 terms, one add at a time, is itself off
    the f64 oracle by 1.0e-5 and 1.4e-5 of its largest magnitude (measured
    on the card), so those two hubs are held to the oracle within 1e-4;
    the 38,000-term hub within test_knn_gather_backward_hub's 1e-5."""
    B, hub = 2, n_points // 3
    idx = torch.full((B, n_points, k), hub, dtype=torch.int64)
    idx[:, :, 0] = torch.arange(n_points)
    idx = idx.to(cuda)
    g = torch.from_numpy(rng.normal(size=(B, k, n_points, C)).astype(np.float32)).to(cuda)
    dx = knn_gather.knn_gather_bwd(idx, g)
    torch.cuda.synchronize()
    assert torch.equal(dx, knn_gather.knn_gather_backward_ordered(idx, g))
    ref_dx = knn_gather.knn_gather_backward_reference(idx, g, 2, torch.float64)
    assert (dx.double() - ref_dx).abs().max().item() <= value_bar * ref_dx.abs().max().item()


@pytest.mark.parametrize('variant', ['pool10', 'gpool', 'aggr_mean', 'aggr_add', 'pointnet'])
def test_encoder_decoder_variant_matches_cpu(cuda, variant):
    """One eval forward of the baseline with each alternative encoder or
    decoder (narrow widths, 2 x 2000 points) on the card against its CPU
    plain path from the same weights: every output within 1e-2 of its
    scale (near-tie ids may move a point's features, as the serving
    phases of chip_smoke.py allow)."""
    from garment_pattern_estimation_torch.models import build_model

    overrides = {
        'pool10': {'feature_extractor': 'EdgeConvPoolingFeatures', 'k_neighbors': 10,
                   'panel_decoder': 'GRUDecoderModule',
                   'pattern_decoder': 'LSTMDoubleReverseDecoderModule'},
        'gpool': {'graph_pooling': True, 'skip_connections': False},
        'aggr_mean': {'EConv_aggr': 'mean'},
        'aggr_add': {'EConv_aggr': 'add'},
        'pointnet': {'feature_extractor': 'PointNetPlusPlus', 'panel_decoder': 'MLPDecoder',
                     'pattern_decoder': 'MLPDecoder'}}[variant]
    data = {'element_size': 4, 'rotation_size': 4, 'translation_size': 3,
            'max_panel_len': 6, 'max_pattern_len': 5}
    nn_config = {'panel_encoding_size': 32, 'panel_hidden_size': 32, 'panel_n_layers': 2,
                 'pattern_encoding_size': 32, 'pattern_hidden_size': 32,
                 'EConv_hidden': 32, 'EConv_feature': 48, 'skip_connections': True,
                 **overrides}
    model = build_model('GarmentFullPattern3D', data, nn_config, device='cpu', seed=3)
    card = copy.deepcopy(model.module).to(cuda)
    x = torch.randn(2, 2000, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        ref = model.module(x)
        out = card(x.to(cuda))
    for key, value in ref.items():
        scale = value.abs().max().item()
        assert (out[key].cpu() - value).abs().max().item() <= 1e-2 * scale, key


# ---- the on-device sampling stage (preprocess/device_sampling.py) ----

def _padded_meshes(rng, batch, n_verts, n_faces, v_cap, f_cap):
    """bench.py's meshes: gaussian vertices x 20, random faces, padded."""
    from garment_pattern_estimation_torch.preprocess.device_sampling import pad_mesh
    meshes = [pad_mesh((rng.normal(size=(n_verts, 3)) * 20).astype(np.float32),
                       rng.integers(0, n_verts, (n_faces, 3)), v_cap, f_cap)
              for _ in range(batch)]
    return {'verts': torch.from_numpy(np.stack([m[0] for m in meshes])),
            'faces': torch.from_numpy(np.stack([m[1] for m in meshes])),
            'n_verts': torch.tensor([m[2] for m in meshes], dtype=torch.int32),
            'vert_labels': torch.from_numpy(
                rng.integers(-1, 23, (batch, v_cap)).astype(np.int32))}


@pytest.mark.parametrize('batch,points,n_verts,n_faces,v_cap,f_cap,noise_w', [
    (2, 60, 200, 400, 256, 512, 0.0),
    (4, 2000, 4000, 8000, 4096, 8192, 0.01),
])
def test_device_sampling_matches_cpu(cuda, rng, batch, points, n_verts, n_faces, v_cap,
                                     f_cap, noise_w):
    """The sampling stage on the card against its CPU core with the same
    draws: face ids equal except draws within 1e-6 x total of a step of the
    cumulative areas or within the devices' own gap on the steps (the
    card's parallel scan rounds otherwise), points
    within 1e-5 of the mesh extent where the ids agree, labels equal there
    except near ties of the f64 distances (1e-5 relative), and no snap
    without labels."""
    from garment_pattern_estimation_torch.preprocess import device_sampling as ds
    mesh = _padded_meshes(rng, batch, n_verts, n_faces, v_cap, f_cap)
    stats = {'f_shift': [0.03, -28.0, 1.07], 'f_scale': [16.3, 30.9, 9.6]}
    sampler = ds.make_batch_sampler({'mesh_samples': points, 'point_noise_w': noise_w,
                                     'standardize': stats})
    draws = sampler.draws(torch.Generator().manual_seed(3), batch, 'cpu')
    on_card = {k: v.to(cuda) for k, v in mesh.items()}
    card_draws = [None if d is None else d.to(cuda) for d in draws]
    ours, our_labels = sampler.from_draws(on_card, *card_draws)
    ref, ref_labels = sampler.from_draws(mesh, *draws)
    assert ours.device == on_card['verts'].device and ours.shape == (batch, points, 3)
    _, our_ids = ds.sample_surface_from_draws(on_card['verts'], on_card['faces'],
                                              *card_draws[:3])
    _, ref_ids = ds.sample_surface_from_draws(mesh['verts'], mesh['faces'], *draws[:3])
    cdf = torch.cumsum(ds.face_areas(mesh['verts'], mesh['faces']), -1).double().numpy()
    card_cdf = torch.cumsum(ds.face_areas(on_card['verts'], on_card['faces']), -1)
    card_cdf = card_cdf.cpu().double().numpy()
    scale = np.asarray(stats['f_scale'])
    for b in range(batch):
        same = our_ids[b].cpu().numpy() == ref_ids[b].numpy()
        step = cdf[b][-1]
        # within 1e-6 of a step, or within the devices' own disagreement on
        # the steps and the total
        slack = np.abs(card_cdf[b] - cdf[b]).max() + abs(card_cdf[b][-1] - step)
        targets = draws[0][b].numpy()[~same].astype(np.float64) * step
        assert np.all(np.abs(targets[:, None] - cdf[b][None]).min(1)
                      <= max(1e-6 * step, slack))
        verts = mesh['verts'][b, :n_verts].numpy()
        gap = np.abs((ours[b].cpu().numpy() - ref[b].numpy()) * scale)[same]
        assert gap.max() <= 1e-5 * float(np.ptp(verts, axis=0).max())
        raw = ref[b].numpy() * scale + np.asarray(stats['f_shift'])
        # where the face ids agree (elsewhere the points themselves differ)
        differ = np.flatnonzero((our_labels[b].cpu().numpy() != ref_labels[b].numpy()) & same)
        for i in differ:
            d = np.sort(((raw[i].astype(np.float64) - verts) ** 2).sum(-1))
            assert d[1] - d[0] <= 1e-5 * max(d[0], 1e-12), i
    _, none = sampler(torch.Generator(device=cuda).manual_seed(1), on_card, labels=False)
    assert none is None


def test_device_sampling_draws_on_the_card(cuda, rng):
    """The sampler draws with a generator on the card: a seed repeats its
    cloud, another seed gives another, and every point is finite."""
    from garment_pattern_estimation_torch.preprocess import device_sampling as ds
    mesh = {k: v.to(cuda) for k, v in _padded_meshes(rng, 3, 200, 400, 256, 512).items()}
    sampler = ds.make_batch_sampler({'mesh_samples': 500, 'point_noise_w': 0.01,
                                     'standardize': {'f_shift': [0, 0, 0],
                                                     'f_scale': [1, 1, 1]}})
    first, labels = sampler(torch.Generator(device=cuda).manual_seed(5), mesh)
    again, _ = sampler(torch.Generator(device=cuda).manual_seed(5), mesh)
    other, _ = sampler(torch.Generator(device=cuda).manual_seed(6), mesh)
    assert torch.equal(first, again) and not torch.equal(first, other)
    assert torch.isfinite(first).all() and labels.dtype == torch.int32
    assert int(labels.min()) >= 0


# ---- data parallelism (parallel/) ----

def _cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f'needs {n} cards')


def test_launchers_follow_the_input_card(cuda, rng):
    """Under `torch.cuda.device(1)` each launcher runs on card 0, where its
    input is: outputs there and equal to the plain versions."""
    _cards(2)
    card0 = torch.device('cuda', 0)
    x = torch.from_numpy(rng.normal(size=(2, 300, 3)).astype(np.float32)).to(card0)
    wide = torch.from_numpy(rng.normal(size=(2, 300, 24)).astype(np.float32)).to(card0)
    folded = _folded(rng, 3, [16, 8], card0)
    with torch.cuda.device(1):
        ids = knn.knn(x, 5)
        wide_ids = knn.knn(wide, 5)
        out, out_ids = edgeconv.fused_edgeconv(x, folded, k=5, return_idx=True)
        nbr, idx = knn_gather.knn_gather_fwd(x, 5)
        dx = knn_gather.knn_gather_bwd(idx, torch.ones_like(nbr))
    torch.cuda.synchronize(card0)
    assert all(t.device == card0 for t in (ids, wide_ids, out, nbr, dx))
    assert torch.equal(ids, knn.knn_reference(x, 5))
    assert (wide_ids == knn.knn_reference(wide, 5)).float().mean().item() >= 0.99
    assert torch.equal(out_ids, edgeconv.edgeconv_select(x, 5, torch.float32)[0])
    assert torch.equal(idx, knn_gather.knn_gather_reference(x, 5)[1])
    ref_dx = knn_gather.knn_gather_backward_reference(idx, torch.ones_like(nbr))
    assert torch.allclose(dx, ref_dx, rtol=1e-6, atol=1e-6)


# tests/torch_parallel_ranks.py's cases with the port's seeded weights:
# random LSTM states and dropout, through the knn_gather kernels or the
# chunked sweeps (the kNN kernel)
CARD_CASES = ('drawn', 'chunked')


def _dp_inputs(tmp_path):
    import torch_parallel_ranks as ranks

    states = {case: ranks.port_state(case) for case in CARD_CASES}
    return ranks, ranks.write_inputs(tmp_path / 'inputs.npz', states), states


def _check_dp(ranks, out, arrays, states, world):
    batch = ranks.batch_of(arrays)
    for case in CARD_CASES:
        losses, grads, eval_loss = ranks.padded_oracle(case, states[case], batch, world, 'cuda:0')
        gap, same_names = ranks.gradient_gap(out, case, grads)
        assert same_names and gap <= 1e-5, (case, gap)
        np.testing.assert_allclose([out[f'{case}.loss0'], out[f'{case}.loss1']], losses,
                                   rtol=1e-5)
        np.testing.assert_allclose(out[f'{case}.eval'], eval_loss, rtol=1e-5)
        assert bool(out[f'{case}.same_params'])


def test_world1_nccl_step_equals_no_group(cuda, tmp_path):
    """A data-parallel step over a world-1 NCCL group (the collectives, the
    gather and the gradient sum all run) against the step without one."""
    import torch.distributed as dist

    ranks, arrays, states = _dp_inputs(tmp_path)
    torch.cuda.set_device(0)
    dist.init_process_group('nccl', store=dist.FileStore(str(tmp_path / 'store'), 1),
                            rank=0, world_size=1)
    try:
        ranks.dp_rank(str(tmp_path / 'inputs.npz'), str(tmp_path / 'out.npz'), CARD_CASES)
    finally:
        dist.destroy_process_group()
    _check_dp(ranks, dict(np.load(tmp_path / 'out.npz')), arrays, states, 1)


def test_nccl_ranks_step_equals_one_process(cuda, tmp_path):
    """R = device_count() NCCL ranks, one card each, against one process on
    the batch padded to R; then `dryrun_multichip(R)`."""
    from garment_pattern_estimation_torch.parallel.dryrun import dryrun_multichip, spawn

    _cards(2)
    world = torch.cuda.device_count()
    ranks, arrays, states = _dp_inputs(tmp_path)
    spawn(ranks.dp_rank, world, str(tmp_path / 'inputs.npz'), str(tmp_path / 'out.npz'),
          CARD_CASES, backend='nccl')
    _check_dp(ranks, dict(np.load(tmp_path / 'out.npz')), arrays, states, world)
    dryrun_multichip(world)


@pytest.mark.parametrize('nproc', [1, 2, 4])
def test_train_cli_under_torchrun(cuda, tmp_path, nproc):
    """`torchrun --standalone --nproc_per_node=G -m ...cli.train` on G cards
    (`init_from_env`: NCCL, each rank on its LOCAL_RANK's card) against the
    CLI in one process without torchrun: the first epoch's validation loss
    within 1e-4 relative, the first step's loss within 1e-5, the same run
    files, and the final evaluation of the best checkpoint on the first rank
    while the others have left the group."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    import torch_parallel_ranks as ranks

    _cards(nproc)
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(repo),
                                                       os.environ.get('PYTHONPATH', '')]))
    root, first_six = repo / 'parity_run' / 'data_big', {'max_datapoints_per_type': 6}
    runs = []
    for name, mesh, launcher in (
            ('one', None, []),
            ('torchrun', {'data': nproc}, ['-m', 'torch.distributed.run', '--standalone',
                                           f'--nproc_per_node={nproc}'])):
        argv = ranks.cli_workdir(root, tmp_path / name, mesh, first_six)
        done = subprocess.run([sys.executable, *launcher, '-m',
                               'garment_pattern_estimation_torch.cli.train', *argv],
                              cwd=tmp_path / name, env=env, capture_output=True, text=True,
                              timeout=600)
        assert done.returncode == 0, done.stderr[-4000:]
        runs.append(ranks.cli_run_files(tmp_path / name))
    (one, files_one), (dp, files_dp) = runs
    assert files_dp == files_one and (dp / 'finished.marker').exists()
    (valid_one,), steps_one = ranks.cli_losses(one)
    (valid_dp,), steps_dp = ranks.cli_losses(dp)
    np.testing.assert_allclose(valid_dp, valid_one, rtol=1e-4)
    np.testing.assert_allclose(steps_dp[0], steps_one[0], rtol=1e-5)
    summary = json.loads((dp / 'summary.json').read_text())
    assert {'valid_on_best.full_loss', 'test_on_best.full_loss'} <= set(summary)


# ---- D and C past 256, edge MLPs of any depth and up to 2048 wide ----

def _check_fused(cuda, rng, n_points, C, widths, k, mlp_dtype=torch.float32, clouds=2,
                 launches=None, tile_n=None):
    """The fused layer against the plain tail on its own ids: small-C ids
    exactly the plain version's, wide ids at least 99% (a near tie of the
    quantized distances otherwise), outputs within 1e-2 of the tail's
    scale and 1e-4 on average; `launches` (1 or 2) launches per call."""
    folded = _folded(rng, C, widths, cuda)
    x = torch.from_numpy(rng.normal(size=(clouds, n_points, C)).astype(np.float32)).to(cuda)
    before = dict(edgeconv.launches_by_shape)
    out, idx = edgeconv.fused_edgeconv(x, folded, k=k, mlp_dtype=mlp_dtype, return_idx=True,
                                       tile_n=tile_n)
    torch.cuda.synchronize()
    made = sum(edgeconv.launches_by_shape.values()) - sum(before.values())
    if launches is not None:
        assert made == launches
    kk = min(k, n_points)
    assert out.shape == (clouds, n_points, widths[-1]) and idx.shape == (clouds, n_points, kk)
    ref_idx, x_lp = edgeconv.edgeconv_select(x, kk, mlp_dtype)
    assert torch.equal(idx[..., 0], ref_idx[..., 0])
    if C <= edgeconv.SMALL_C_MAX:
        assert torch.equal(idx, ref_idx)
    else:
        assert (idx == ref_idx).float().mean().item() >= 0.99
    tail = edgeconv.edgeconv_mlp_max(x, idx, x_lp, folded)
    scale = tail.abs().max().item()
    diff = (out - tail).abs()
    assert diff.max().item() <= 1e-2 * scale and diff.mean().item() <= 1e-4 * scale


@pytest.mark.parametrize('n_points,C,widths,k,launches', [
    (2000, 3, [512, 512, 150], 5, 1),        # att conv0 at EConv_hidden 512: 5 slots fit
    (2000, 150, [512, 512, 150], 5, 1),      # conv1
    (2000, 3, [200] * 4 + [150], 5, 1),      # EConv_hidden_depth 4: five layers
    (2000, 150, [200] * 4 + [150], 20, 1),
    (300, 150, [512, 512, 150], 20, 2),      # 8 slots of 520 columns do not fit: 4
    (300, 24, [1024, 150], 5, 2),            # 2 slots a group
    (300, 3, [2048, 64], 5, 2),              # 1 slot a group, the widest layer
    (3000, 3, [512, 512, 150], 8, 2),        # column-tiled small C
    (2500, 150, [1024, 64], 5, 2),           # column-tiled wide C
    (2000, 300, [200, 200, 150], 5, 2),      # att conv1 at EConv_feature 300
    (3000, 300, [200, 200, 150], 5, 2),      # past 2048 points
    (500, 512, [64, 32], 20, 2),
    (200, 1000, [64, 32], 1, 2),             # 2C = 2000 columns of edge input
])
def test_kernel_wide_shapes_match_plain(cuda, rng, n_points, C, widths, k, launches):
    for mlp_dtype in (torch.float32, torch.bfloat16):
        _check_fused(cuda, rng, n_points, C, widths, k, mlp_dtype, launches=launches)


@pytest.mark.parametrize('C', [300, 512])
@pytest.mark.parametrize('n_points,k,value_chunks', [(300, 5, 2), (2000, 5, 2), (2000, 5, 1),
                                                     (2000, 20, 2), (2048, 1, 2)])
def test_knn_gather_past_256_matches_plain(cuda, rng, C, n_points, k, value_chunks):
    """knn_gather at C past 256 (the selection staged 256 features at a
    time, the backward's sums in 256-column blocks): the bars of
    test_knn_gather_matches_plain."""
    test_knn_gather_matches_plain(cuda, rng, n_points, C, k, value_chunks)


@pytest.mark.parametrize('n_points,k,C,value_chunks', [
    (2000, 5, 300, 2), (2048, 20, 512, 1), (300, 200, 300, 2)])
def test_knn_gather_backward_past_256(cuda, rng, n_points, k, C, value_chunks):
    test_knn_gather_backward_order(cuda, rng, n_points, k, C, value_chunks)
    if k <= 20:           # a hub of N (k-1) <= 38,000 terms: the 1e-5 bar holds
        test_knn_gather_backward_hub(cuda, rng, n_points, k, C, value_chunks)


def test_fused_widths_past_2048_raise(cuda, rng):
    folded = _folded(rng, 3, [2056, 8], cuda)
    with pytest.raises(NotImplementedError, match='2048'):
        edgeconv.fused_edgeconv(torch.randn(1, 100, 3, device=cuda), folded, k=5)


def test_edgeconv_routes_past_2048_to_knn_gather(cuda, rng):
    """An eval layer wider than the fused kernels take runs knn_gather, the
    edge MLP and the max, as the CPU path does."""
    layer = EdgeConv(3, [2056, 16], k=5).eval()
    x = torch.from_numpy(rng.normal(size=(2, 300, 3)).astype(np.float32))
    before_fused = sum(launches_by_variant(edgeconv).values())
    before = launches_by_variant(knn_gather)['fwd_small_c']
    with torch.no_grad():
        out = copy.deepcopy(layer).to(cuda)(x.to(cuda))
        ref = layer(x)
    torch.cuda.synchronize()
    assert sum(launches_by_variant(edgeconv).values()) == before_fused
    assert launches_by_variant(knn_gather)['fwd_small_c'] == before + 1
    assert _rel_l2(out, ref) <= 1e-5


# ---- 128 < k <= N: the selection of all N keys ----

@pytest.mark.parametrize('k', [129, 200])
@pytest.mark.parametrize('n_points,C,widths,clouds', [
    (256, 3, [16], 2), (256, 24, [16], 2),   # the CPU tests' shapes
    (2000, 3, [200, 200, 150], 2),           # row 4: the att conv0
    (2000, 150, [200, 200, 150], 2),         # row 5: conv1
    (10000, 3, [200, 200, 150], 1),          # row 6
    (10000, 150, [200, 200, 150], 1),        # row 7
    (2000, 300, [512, 150], 1),              # C past 256 and a wide layer
])
def test_kernel_above_k128_matches_plain(cuda, rng, k, n_points, C, widths, clouds):
    for mlp_dtype in (torch.float32, torch.bfloat16):
        _check_fused(cuda, rng, n_points, C, widths, k, mlp_dtype, clouds=clouds, launches=2)


def test_kernel_k_equal_to_n(cuda, rng):
    """k = N: every point is a neighbour."""
    _check_fused(cuda, rng, 300, 3, [32, 16], 300, launches=2)
    _check_fused(cuda, rng, 300, 150, [32, 16], 300, launches=2)


@pytest.mark.parametrize('k', [129, 200])
@pytest.mark.parametrize('n_points,C,value_chunks', [
    (2000, 3, 2), (2000, 150, 2), (2000, 150, 1), (256, 24, 2), (2048, 300, 2)])
def test_knn_gather_above_k128_matches_plain(cuda, rng, k, n_points, C, value_chunks):
    """Rows 8-9 at k = 129 and 200: ids (B, N, k) and rows (B, k, N, C),
    the backward's CSR at the run-time k: the bars of
    test_knn_gather_matches_plain."""
    test_knn_gather_matches_plain(cuda, rng, n_points, C, k, value_chunks)


@pytest.mark.parametrize('n_points,k,C,value_chunks', [
    (n, k, c, v) for n in (300, 2048) for k in (129, 200) for c in (3, 150) for v in (1, 2)])
def test_knn_gather_backward_order_above_k128(cuda, rng, n_points, k, C, value_chunks):
    test_knn_gather_backward_order(cuda, rng, n_points, k, C, value_chunks)


def test_small_c_above_k128_duplicates_and_ties(cuda, rng):
    """Integer lattice clouds, every point twice: the radix selection's ties
    go to the lower column, in the fused layer and knn_gather alike."""
    x = torch.from_numpy(rng.integers(-3, 4, size=(2, 600, 3)).astype(np.float32))
    x[:, 300:] = x[:, :300]
    x = x.to(cuda)
    folded = _folded(rng, 3, [16, 8], cuda)
    for k in (129, 200, 600):
        ref = knn_gather.knn_gather_reference(x, k)[1]
        _, idx = edgeconv.fused_edgeconv(x, folded, k=k, return_idx=True)
        assert torch.equal(idx, ref)
        assert torch.equal(knn_gather.knn_gather(x, k)[1], ref)
