"""Every shape the JAX package takes: D and C past 256, edge MLPs of any
depth and up to 2048 wide, and 128 < k <= N in the fused layer and
knn_gather. The port's plain versions (its CPU path) against the JAX
package on the same seeded numpy inputs; the JAX side through its Pallas
kernels in interpret mode, or through its plain oracles where those
kernels are wrong or would take minutes.

Where the JAX kernels are wrong (k > 128). The column-tiled fused kernels
carry 128 candidate lanes through their merges across tiles, and knn_gather
returns 128 ids, so slots past 128 are lost: its backward misroutes their
cotangents. The port is held to the JAX package's own statements of the
semantics there, `fused_edgeconv_reference` and `knn_gather_reference`
(with `jax.vjp` of the latter for dx). The single-tile fused kernel is
right at k = 200 and is held directly.

Tolerances, those of the k = 5 files:
  * kNN ids at wide D: at least 99% equal, every difference within 2^-18
    of the squared norms (tests/test_torch_knn_wide.py);
  * fused layer: 1e-2 of the output's largest magnitude at most, 1e-4 on
    average (tests/test_torch_edgeconv.py);
  * knn_gather: ids exactly (small C) or as the wide kNN's, rows 1e-6 where
    the ids agree, dx 1e-4 relative / 3e-4 absolute
    (tests/test_torch_knn_gather.py).

Routing: a CUDA tensor at these shapes reaches the kernels' library calls
and never the plain versions; the models route a layer wider than 2048 to
knn_gather. A stand-in CUDA tensor and a fake library make that checkable
without a card.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from garment_pattern_estimation_tpu.ops import edgeconv as jax_edgeconv
from garment_pattern_estimation_tpu.ops.knn import knn_pallas
from garment_pattern_estimation_tpu.ops.knn_gather import (
    knn_gather as jax_knn_gather, knn_gather_reference as jax_knn_gather_reference)
from garment_pattern_estimation_torch.models import blocks
from garment_pattern_estimation_torch.ops import edgeconv, knn, knn_gather, launches_by_variant
from test_torch_edgeconv import (_assert_close_to_scale, _jax_fold, _lattice, _synthetic_mlp,
                                 _torch_fold)
from test_torch_k_range import _CudaStandIn, fake_card  # noqa: F401 (a fixture)
from test_torch_knn_wide import _assert_equal_but_near_ties

torch.set_num_threads(1)


# ---- Part I: D and C past 256 ----

@pytest.mark.parametrize('D', [300, 512])
def test_knn_past_256_matches_jax_pallas(rng, D):
    """knn_pallas pads D to a multiple of 128 with no bound; the port's
    wide-D kNN takes any D."""
    x = rng.normal(size=(1, 256, D)).astype(np.float32)
    ref = np.asarray(knn_pallas(jnp.asarray(x), 20, interpret=True))
    ids = knn.knn(torch.from_numpy(x), 20).numpy()
    assert ids.shape == ref.shape == (1, 256, 20)
    assert (ids == ref).mean() >= 0.99
    _assert_equal_but_near_ties(x, ids, ref)


@pytest.mark.parametrize('value_chunks', [1, 2])
def test_knn_gather_past_256_matches_jax_kernel(rng, value_chunks):
    """knn_gather at C = 300: ids, rows and dx against the interpret-mode
    kernels."""
    x = rng.normal(size=(2, 96, 300)).astype(np.float32)
    g = rng.normal(size=(2, 5, 96, 300)).astype(np.float32)
    ref_nbr, ref_idx = jax_knn_gather(jnp.asarray(x), 5, True, value_chunks)
    _, vjp = jax.vjp(lambda v: jax_knn_gather(v, 5, True, value_chunks)[0], jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    nbr, idx = knn_gather.knn_gather(xt, 5, value_chunks)
    nbr.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(nbr.detach().numpy(), np.asarray(ref_nbr), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), rtol=1e-4, atol=3e-4)


@pytest.mark.parametrize('C,sizes', [
    (3, [(6, 512), (512, 24)]),                              # a 512-wide layer
    (3, [(6, 64)] + [(64, 64)] * 3 + [(64, 24)]),            # five layers
    (24, [(48, 40)] * 1 + [(40, 40)] * 4 + [(40, 16)]),      # six, wide C
])
def test_fused_reference_wide_and_deep_mlp_matches_jax_kernel(rng, C, sizes):
    layers = _synthetic_mlp(rng, sizes)
    x = rng.normal(size=(1, 64, C)).astype(np.float32)
    kernel = jax_edgeconv.fused_edgeconv(jnp.asarray(x), _jax_fold(layers), k=5, interpret=True)
    out = edgeconv.fused_edgeconv(torch.from_numpy(x), _torch_fold(layers), k=5)
    _assert_close_to_scale(out.numpy(), np.asarray(kernel))


def test_fused_reference_past_256_matches_jax_kernel(rng):
    """The fused layer at C = 300 (the JAX fused kernel has no C bound; the
    models route such a layer to knn_gather, as the JAX models do)."""
    layers = _synthetic_mlp(rng, [(600, 32), (32, 16)])
    x = rng.normal(size=(1, 64, 300)).astype(np.float32)
    kernel = jax_edgeconv.fused_edgeconv(jnp.asarray(x), _jax_fold(layers), k=5, interpret=True)
    out = edgeconv.fused_edgeconv(torch.from_numpy(x), _torch_fold(layers), k=5)
    _assert_close_to_scale(out.numpy(), np.asarray(kernel))


# ---- Part II: 128 < k <= N ----

@pytest.mark.parametrize('k', [129, 200])
@pytest.mark.parametrize('C', [3, 24])
def test_fused_single_tile_above_k128_matches_jax_kernel(rng, k, C):
    """The single-tile fused kernel, which is right past 128 (k clamps at
    N and has no other bound)."""
    layers = _synthetic_mlp(rng, [(2 * C, 16)])
    x = rng.normal(size=(2, 256, C)).astype(np.float32)
    kernel = jax_edgeconv.fused_edgeconv(jnp.asarray(x), _jax_fold(layers), k=k, interpret=True)
    out = edgeconv.fused_edgeconv(torch.from_numpy(x), _torch_fold(layers), k=k)
    _assert_close_to_scale(out.numpy(), np.asarray(kernel))


@pytest.mark.parametrize('k', [129, 200])
@pytest.mark.parametrize('C', [3, 24])
def test_fused_tiled_above_k128_matches_jax_reference(rng, k, C):
    """The column tile forced as the tiled tests force it (tile_n = 128 on
    256 points); held to `fused_edgeconv_reference`, since the JAX tiled
    kernels lose the slots past their 128 candidate lanes."""
    layers = _synthetic_mlp(rng, [(2 * C, 16)])
    x = rng.normal(size=(2, 256, C)).astype(np.float32)
    ref = jax_edgeconv.fused_edgeconv_reference(jnp.asarray(x), _jax_fold(layers), k)
    out = edgeconv.fused_edgeconv(torch.from_numpy(x), _torch_fold(layers), k=k, tile_n=128)
    _assert_close_to_scale(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize('C', [3, 24])
def test_knn_gather_k200_matches_jax_reference(rng, C):
    """knn_gather at k = 200 against `knn_gather_reference` (the JAX kernel
    returns 128 ids there): ids, rows and dx through `jax.vjp`. Wide C on
    an integer lattice, whose split products and sums are exact in both
    packages, so no near tie can rank the ids apart (on normal clouds 2 of
    102,400 ids differ, each a near tie of the quantized distance)."""
    x = rng.normal(size=(2, 256, C)).astype(np.float32) if C <= 16 \
        else _lattice(rng, (2, 256, C), 3)
    g = rng.normal(size=(2, 200, 256, C)).astype(np.float32)
    ref_nbr, ref_idx = jax_knn_gather_reference(jnp.asarray(x), 200)
    _, vjp = jax.vjp(lambda v: jax_knn_gather_reference(v, 200)[0], jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    nbr, idx = knn_gather.knn_gather(xt, 200)
    nbr.backward(torch.from_numpy(g))
    assert tuple(idx.shape) == (2, 256, 200) and tuple(nbr.shape) == (2, 200, 256, C)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(nbr.detach().numpy(), np.asarray(ref_nbr), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), rtol=1e-4, atol=3e-4)


def test_knn_gather_first_128_slots_match_jax_kernel(rng):
    """The JAX kernel at k = 200 returns its first 128 ids right: the
    port's first 128 slots equal them."""
    x = rng.normal(size=(1, 256, 3)).astype(np.float32)
    _, kernel_idx = jax_knn_gather(jnp.asarray(x), 200, True)
    _, idx = knn_gather.knn_gather(torch.from_numpy(x), 200)
    np.testing.assert_array_equal(idx.numpy()[..., :128], np.asarray(kernel_idx)[..., :128])


# ---- routing on the card ----

def _plain_raises(monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError('a CUDA tensor reached the plain version')

    for name in ('fused_edgeconv_reference', 'edgeconv_select'):
        monkeypatch.setattr(edgeconv, name, plain)


@pytest.mark.parametrize('D', [257, 300, 512])
def test_knn_past_256_reaches_the_wide_kernel(fake_card, D):
    knn.launches_by_shape.clear()
    ids = knn.knn(_CudaStandIn(2, 2000, D), 5)
    assert tuple(ids.shape) == (2, 2000, 5)
    assert [name for name, _ in fake_card.calls if name.endswith('_forward')] == \
        ['knn_wide_forward']
    assert D in fake_card.calls[-1][1]
    assert launches_by_variant(knn)['knn_wide'] == 1


@pytest.mark.parametrize('k,C', [(5, 300), (20, 512), (129, 3), (200, 150), (200, 300),
                                 (2000, 3)])
def test_knn_gather_reaches_the_kernels(fake_card, k, C):
    knn_gather.launches_by_shape.clear()
    nbr, idx = knn_gather.knn_gather_fwd(_CudaStandIn(2, 2000, C), k)
    assert tuple(nbr.shape) == (2, k, 2000, C) and tuple(idx.shape) == (2, 2000, k)
    dx = knn_gather.knn_gather_bwd(_CudaStandIn(2, 2000, k), _CudaStandIn(2, k, 2000, C))
    assert tuple(dx.shape) == (2, 2000, C)
    launched = [(name, args) for name, args in fake_card.calls if 'ward' in name]
    assert [name for name, _ in launched] == ['knn_gather_forward', 'knn_gather_backward']
    assert all(k in args and C in args for _, args in launched)
    variant = 'fwd_small_c' if C <= 16 else 'fwd_wide_c'
    counts = launches_by_variant(knn_gather)
    assert counts[variant] == 1 and counts['bwd'] == 1
    suffixes = ('_select', '_rows') if k > knn.MAX_K else ('',)
    assert sorted(knn_gather.launches_by_shape) == sorted(
        [(variant + s, 2000, C, k) for s in suffixes] + [('bwd', 2000, C, k)])


def test_knn_still_raises_past_128(fake_card):
    with pytest.raises(NotImplementedError, match='knn_gather'):
        knn.knn(_CudaStandIn(1, 200, 3), 129)


class _Tensor(_CudaStandIn):
    """A stand-in with the attributes the fused launcher's packing reads."""

    def __init__(self, *shape):
        super().__init__(*shape)

    def data_ptr(self):
        return 0

    def is_contiguous(self):
        return True

    def float(self):
        return self

    def new_empty(self, shape, dtype=None):
        return torch.empty(shape, dtype=dtype)


@pytest.mark.parametrize('C,widths,k,launches', [
    (3, [200] * 4 + [150], 5, 1), (3, [512, 512, 150], 5, 1), (150, [1024, 150], 5, 2),
    (300, [200, 200, 150], 5, 2), (3, [200, 200, 150], 200, 2), (150, [64], 2000, 2)])
def test_fused_edgeconv_reaches_the_kernels(monkeypatch, fake_card, C, widths, k, launches):
    """The launcher passes its checks at any depth, widths to 2048, C past
    256 and k past 128, asks the library how many launches the layer takes
    and calls it with the layer table; a two-launch layer gets an ids
    buffer and counts both launches."""
    _plain_raises(monkeypatch)
    monkeypatch.setattr(edgeconv, '_pack_weight', lambda w: w)
    monkeypatch.setattr(edgeconv, '_pad_vector', lambda v: v)
    monkeypatch.setattr(edgeconv, '_layer_table', lambda *args: _Tensor(1))
    fake_card.fused_edgeconv_launches = lambda *args: launches
    edgeconv.launches_by_shape.clear()
    dims = [2 * C, *widths]
    layers = [(_Tensor(i, o), _Tensor(o)) for i, o in zip(dims[:-1], dims[1:])]
    out, idx = edgeconv._launch(_Tensor(2, 2000, C), (layers, (_Tensor(dims[-1]),) * 2), k,
                                torch.float32, False, None)
    assert tuple(out.shape) == (2, 2000, widths[-1])
    (name, args), = [c for c in fake_card.calls if c[0] == 'fused_edgeconv_forward']
    assert args[2] is not None if launches == 2 else args[2] is None
    assert args[5:12] == (2, 2000, C, k, 2, len(widths), 0)
    variant = 'small_c' if C <= 16 else 'wide_c'
    assert launches_by_variant(edgeconv)[variant] == 1
    keys = [(variant, 2000, C, k)] if launches == 1 else \
        [(variant + '_select', 2000, C, k), (variant + '_mlp', 2000, C, k)]
    assert sorted(edgeconv.launches_by_shape) == sorted(keys)


def test_fused_edgeconv_past_2048_raises_naming_the_route(monkeypatch, fake_card):
    _plain_raises(monkeypatch)
    layers = [(_Tensor(6, 4096), _Tensor(4096)), (_Tensor(4096, 8), _Tensor(8))]
    with pytest.raises(NotImplementedError, match='knn_gather'):
        edgeconv._launch(_Tensor(1, 200, 3), (layers, (_Tensor(8),) * 2), 5, torch.float32,
                         False, None)


@pytest.mark.parametrize('n,c,widths,supported', [
    (2000, 3, [2048, 150], True), (2000, 3, [2049, 150], False), (2000, 150, [512], True),
    (2000, 257, [64], False), (16384, 3, [64], True), (16385, 3, [64], False)])
def test_fused_edgeconv_supported_by_shape_and_widths(n, c, widths, supported):
    assert edgeconv.fused_edgeconv_supported(n, c, widths) is supported


@pytest.mark.parametrize('training', [False, True])
def test_edgeconv_routes_layers_past_2048_to_knn_gather(monkeypatch, training):
    """A layer wider than the fused kernels take, in eval as in train: the
    model routes it to knn_gather (N <= 2048), then the edge MLP and the max,
    never to the fused layer."""
    calls = []

    def gather(x, k, value_chunks=2):
        calls.append(k)
        return knn_gather.knn_gather_reference(x, k, value_chunks)[0], None

    monkeypatch.setattr(blocks, 'knn_gather', gather)
    monkeypatch.setattr(blocks, 'fused_edgeconv',
                        lambda *args, **kwargs: pytest.fail('the fused layer'))
    layer = blocks.EdgeConv(3, [2056, 8], k=5).train(training)
    out = layer(torch.randn(2, 50, 3))
    assert tuple(out.shape) == (2, 50, 8) and calls == [5]
