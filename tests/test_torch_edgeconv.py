"""The port's fused EdgeConv against the JAX package's: `fold_mlp_bn`, the
bf16 truncation split, and the plain PyTorch layer against the JAX oracle
`fused_edgeconv_reference` and the Pallas kernel in interpret mode, for the
small-C (exact per-dimension) and the wide-C (split-product) variants.

Tolerances. Products in the edge MLP are exact (bf16 x bf16 into f32), but
the f32 sums run in another order in torch and XLA; a 1-ulp difference can
flip the bf16 truncation of an activation, which moves that element by up
to 2^-8 of itself. Outputs are therefore held to 1e-2 of the output's
largest magnitude (a flip stays well below it, a wrong neighbour or a wrong
weight does not), and on average to 1e-4 of it. Neighbour ids are held
exactly on integer-lattice clouds, whose squared distances are exact
integers below 2^13 in every path, so no two paths can rank them apart.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from garment_pattern_estimation_tpu.ops import edgeconv as jax_edgeconv
from garment_pattern_estimation_tpu.ops.knn import split_bf16 as jax_split_bf16
from garment_pattern_estimation_torch.ops import edgeconv, knn

torch.set_num_threads(1)

OUT_MAX_REL = 1e-2
OUT_MEAN_REL = 1e-4


def _synthetic_mlp(rng, sizes):
    """Per layer: Dense kernel (in, out), bias, and BN scale, bias, mean,
    var with non-trivial statistics so the folding is exercised."""
    layers = []
    for fan_in, fan_out in sizes:
        layers.append({
            'kernel': rng.normal(size=(fan_in, fan_out)).astype(np.float32) * 0.3,
            'bias': rng.normal(size=fan_out).astype(np.float32) * 0.1,
            'scale': rng.uniform(0.5, 1.5, fan_out).astype(np.float32),
            'bn_bias': rng.normal(size=fan_out).astype(np.float32) * 0.1,
            'mean': rng.normal(size=fan_out).astype(np.float32) * 0.1,
            'var': rng.uniform(0.5, 2.0, fan_out).astype(np.float32)})
    return layers


def _jax_fold(layers):
    params, stats = {}, {}
    for i, l in enumerate(layers):
        params[f'Dense_{i}'] = {'kernel': jnp.asarray(l['kernel']),
                                'bias': jnp.asarray(l['bias'])}
        params[f'BatchNorm_{i}'] = {'scale': jnp.asarray(l['scale']),
                                    'bias': jnp.asarray(l['bn_bias'])}
        stats[f'BatchNorm_{i}'] = {'mean': jnp.asarray(l['mean']),
                                   'var': jnp.asarray(l['var'])}
    return jax_edgeconv.fold_mlp_bn(params, stats)


def _torch_fold(layers):
    return edgeconv.fold_mlp_bn([
        (torch.from_numpy(l['kernel'].T.copy()), torch.from_numpy(l['bias']),
         torch.from_numpy(l['scale']), torch.from_numpy(l['bn_bias']),
         torch.from_numpy(l['mean']), torch.from_numpy(l['var'])) for l in layers])


def _assert_close_to_scale(out, ref):
    scale = float(np.abs(ref).max())
    diff = np.abs(np.asarray(out) - np.asarray(ref))
    assert out.shape == ref.shape
    assert diff.max() <= OUT_MAX_REL * scale, (diff.max(), scale)
    assert diff.mean() <= OUT_MEAN_REL * scale, (diff.mean(), scale)


def _lattice(rng, shape, span):
    return rng.integers(-span, span + 1, size=shape).astype(np.float32)


def _exact_neighbours(x, k):
    """Self, then the k-1 nearest others by (exact distance, column)."""
    B, N, _ = x.shape
    d = ((x[:, :, None, :].astype(np.float64) - x[:, None, :, :]) ** 2).sum(-1)
    idx = np.empty((B, N, k), np.int64)
    cols = np.arange(N)
    for b in range(B):
        for n in range(N):
            dn = d[b, n].copy()
            dn[n] = np.inf
            order = np.lexsort((cols, dn))
            idx[b, n] = [n, *order[:k - 1]]
    return idx


def test_fold_mlp_bn_matches_jax(rng):
    layers = _synthetic_mlp(rng, [(12, 24), (24, 24), (24, 16)])
    jax_layers, (ja, jd) = _jax_fold(layers)
    torch_layers, (ta, td) = _torch_fold(layers)
    for (jw, jb), (tw, tb) in zip(jax_layers, torch_layers):
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('terms', [1, 2, 3])
def test_split_bf16_bitwise_matches_jax(rng, terms):
    x = np.concatenate([rng.normal(size=500) * 10.0 ** rng.integers(-20, 20, 500),
                        [0.0, -0.0, 1.0, -1.0, 3.0e38, 1e-40]]).astype(np.float32)
    ours = knn.split_bf16(torch.from_numpy(x), terms=terms)
    theirs = jax_split_bf16(jnp.asarray(x), terms=terms)
    assert len(ours) == terms
    for o, t in zip(ours, theirs):
        np.testing.assert_array_equal(o.numpy().view(np.int32),
                                      np.asarray(t).view(np.int32))
    # truncation, not rounding: the first chunk is the bf16 bit mask
    np.testing.assert_array_equal(
        knn.truncate_bf16(torch.from_numpy(x)).numpy().view(np.int32),
        x.view(np.int32) & ~0xFFFF)


@pytest.mark.parametrize('n_points,C,span', [
    (120, 3, 30),    # small-C: the xyz layer
    (100, 24, 8),    # wide-C: entries <= 8 are bf16-exact, distances < 2^13
])
def test_lattice_neighbours_are_exact(rng, n_points, C, span):
    x = _lattice(rng, (2, n_points, C), span)
    idx, _ = edgeconv.edgeconv_select(torch.from_numpy(x), k=5)
    np.testing.assert_array_equal(idx.numpy(), _exact_neighbours(x, 5))


@pytest.mark.parametrize('n_points,C,mlp_dtype,lattice', [
    (128, 3, 'float32', True),
    (200, 6, 'float32', False),
    (128, 24, 'float32', False),
    (128, 24, 'bfloat16', False),
])
def test_reference_matches_jax_reference(rng, n_points, C, mlp_dtype, lattice):
    layers = _synthetic_mlp(rng, [(2 * C, 16), (16, 16), (16, 24)])
    x = _lattice(rng, (2, n_points, C), 30) if lattice \
        else rng.normal(size=(2, n_points, C)).astype(np.float32)
    ref = jax_edgeconv.fused_edgeconv_reference(
        jnp.asarray(x), _jax_fold(layers), 5, getattr(jnp, mlp_dtype))
    out = edgeconv.fused_edgeconv_reference(
        torch.from_numpy(x), _torch_fold(layers), 5, getattr(torch, mlp_dtype))
    _assert_close_to_scale(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize('n_points,C', [(100, 3), (100, 24)])
def test_reference_matches_jax_interpret_kernel(rng, n_points, C):
    layers = _synthetic_mlp(rng, [(2 * C, 16), (16, 16), (16, 24)])
    x = rng.normal(size=(2, n_points, C)).astype(np.float32)
    kernel = jax_edgeconv.fused_edgeconv(jnp.asarray(x), _jax_fold(layers), k=5,
                                         interpret=True)
    launches = dict(edgeconv.launches)
    out = edgeconv.fused_edgeconv(torch.from_numpy(x), _torch_fold(layers), k=5)
    assert edgeconv.launches == launches      # the CPU takes the plain version
    _assert_close_to_scale(out.numpy(), np.asarray(kernel))


def test_small_c_distances_are_bitwise_the_kernels_order(rng):
    """The small-C selection sums d*d per dimension in order 0, 1, 2, with no
    fused multiply-add: on non-lattice clouds the ids still equal those of
    an exact f32 recomputation in that order."""
    x = rng.normal(size=(1, 64, 3)).astype(np.float32)
    idx, _ = edgeconv.edgeconv_select(torch.from_numpy(x), k=5)
    diff = x[0, :, None, :] - x[0, None, :, :]
    sq = diff * diff
    d = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    q = (d.view(np.int32) & ~knn.IDX_MASK).astype(np.int64)
    np.fill_diagonal(q, knn.INT_MAX)
    expect = np.argsort(q * 4096 + np.arange(64), axis=1, kind='stable')[:, :4]
    np.testing.assert_array_equal(idx[0, :, 1:].numpy(), expect)
    np.testing.assert_array_equal(idx[0, :, 0].numpy(), np.arange(64))


def test_wrapper_refuses_other_devices(rng):
    layers = _synthetic_mlp(rng, [(6, 8), (8, 8)])
    x = torch.zeros(1, 8, 3, device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        edgeconv.fused_edgeconv(x, _torch_fold(layers), k=3)



def _fragment_product(a, packed, din, dout):
    """a (R, din) @ W as the kernel forms it from the packed weights: for
    each 16-deep step and 8-column n-tile, lane L's B fragment registers b0
    (rows 2 (L % 4) + {0, 1}) and b1 (rows 8 + 2 (L % 4) + {0, 1}) of
    column L // 4, read at ((ks * Dout / 8 + nt) * 32 + L) * 4 + 2 r + e."""
    ks_n, n_tiles = -(-din // 16), 2 * -(-dout // 16)
    frags = packed.float().numpy().reshape(ks_n, n_tiles, 32, 2, 2)   # [ks][nt][L][r][e]
    w = np.zeros((16 * ks_n, 8 * n_tiles))
    for lane in range(32):
        for r in range(2):
            for e in range(2):
                rows = 16 * np.arange(ks_n)[:, None] + 8 * r + 2 * (lane % 4) + e
                cols = 8 * np.arange(n_tiles)[None, :] + lane // 4
                w[rows, cols] = frags[:, :, lane, r, e]
    a_pad = np.zeros((a.shape[0], 16 * ks_n))
    a_pad[:, :din] = a
    return (a_pad @ w)[:, :dout], w


@pytest.mark.parametrize('din,dout', [(6, 200), (300, 200), (200, 150), (40, 17), (17, 24)])
def test_packed_weights_are_the_kernels_b_fragments(rng, din, dout):
    """The wrapper's weight packing, read back in the kernel's mma.sync
    B-fragment order, is the bf16-rounded matrix, zero in its padding; so
    the kernel's product is a @ bf16(W) up to f32 summation order."""
    w = torch.from_numpy(rng.normal(size=(din, dout)).astype(np.float32))
    packed = edgeconv._pack_weight(w)
    assert packed.dtype == torch.bfloat16
    assert packed.numel() == -(-din // 16) * 16 * -(-dout // 16) * 16
    a = rng.normal(size=(48, din))
    out, w_full = _fragment_product(a, packed, din, dout)
    w_bf = w.to(torch.bfloat16).double().numpy()
    np.testing.assert_array_equal(w_full[:din, :dout], w_bf)
    assert not w_full[din:].any() and not w_full[:, dout:].any()
    np.testing.assert_allclose(out, a @ w_bf, rtol=1e-12, atol=1e-12)
