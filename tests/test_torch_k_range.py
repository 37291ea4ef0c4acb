"""k above 16: the port's plain versions against the JAX package at the k
its kernels take past the port's old bound (the capacity instances K = 32,
64 and 128 on the card), and the wrappers' routing of such a k.

The JAX side runs its Pallas kernels in interpret mode (the fused layer,
knn_gather and `knn_pallas`, forced onto small tiles so its merges run
where k fits a tile) or its plain reference where interpret mode would
take minutes; the port runs its plain versions on CPU tensors. Same seeded numpy inputs on both sides.

Tolerances, those of the k = 5 files:
  * kNN ids: small D exactly (tests/test_torch_knn.py); wide D at least 99%
    equal, every difference within 2^-18 of the squared norms
    (tests/test_torch_knn_wide.py);
  * fused layer: 1e-2 of the output's largest magnitude at most, 1e-4 on
    average (tests/test_torch_edgeconv.py);
  * knn_gather: ids exactly, rows 1e-6, dx 1e-4 relative / 3e-4 absolute
    (tests/test_torch_knn_gather.py).
The EdgeConv module and the att model at k_neighbors 20 are held to the
JAX package in tests/test_torch_k_range_model.py.

Routing: a CUDA tensor at every k in 17..128 reaches the kernel's library
call with that k and never the plain version; k = 129 in the standalone
kNN raises NotImplementedError naming 128 (the fused layer and knn_gather
take it: tests/test_torch_wide_shapes.py). A stand-in CUDA tensor and a fake library
make that checkable without a card.
"""
import contextlib
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from garment_pattern_estimation_tpu.ops import edgeconv as jax_edgeconv
from garment_pattern_estimation_tpu.ops.knn import knn_pallas
from garment_pattern_estimation_tpu.ops.knn_gather import knn_gather as jax_knn_gather
from garment_pattern_estimation_torch.ops import (
    _build, edgeconv, knn, knn_gather, launches_by_variant)
from test_torch_edgeconv import _assert_close_to_scale, _jax_fold, _synthetic_mlp, _torch_fold
from test_torch_knn_wide import _assert_equal_but_near_ties

torch.set_num_threads(1)

K_RANGE = (17, 20, 40)


def _jax_ids(x, k):
    """knn_pallas in interpret mode on 64-column tiles (k < 64: its merges
    of tiles run) or its default tiles (a 64-column tile cannot hold k
    candidates)."""
    tiles = {'tile_m': 16, 'tile_n': 64} if k < 64 else {}
    return np.asarray(knn_pallas(jnp.asarray(x), k, interpret=True, **tiles))


# ---- rows 1-3: the standalone kNN ----

@pytest.mark.parametrize('k,shape', [*((k, (2, 100, 3)) for k in K_RANGE), (20, (1, 90, 16))])
def test_knn_small_d_matches_jax_pallas(rng, k, shape):
    x = rng.normal(size=shape).astype(np.float32)
    ids = knn.knn(torch.from_numpy(x), k)
    assert tuple(ids.shape) == (*shape[:2], k)
    np.testing.assert_array_equal(ids.numpy(), _jax_ids(x, k))


def test_knn_small_d_at_128_matches_jax_pallas(rng):
    """knn_pallas's own bound, k = 128, on a cloud of 160 points."""
    x = rng.normal(size=(1, 160, 3)).astype(np.float32)
    np.testing.assert_array_equal(knn.knn(torch.from_numpy(x), 128).numpy(), _jax_ids(x, 128))


@pytest.mark.parametrize('k,shape', [*((k, (1, 100, 24)) for k in K_RANGE),
                                     (128, (1, 150, 40))])
def test_knn_wide_d_matches_jax_pallas(rng, k, shape):
    x = rng.normal(size=shape).astype(np.float32)
    ids = knn.knn(torch.from_numpy(x), k).numpy()
    ref = _jax_ids(x, k)
    assert (ids == ref).mean() >= 0.99
    _assert_equal_but_near_ties(x, ids, ref)


# ---- rows 4-7: the fused layer ----

@pytest.mark.parametrize('C', [3, 24])
@pytest.mark.parametrize('mlp_dtype', ['float32', 'bfloat16'])
def test_fused_edgeconv_matches_jax_interpret_kernel_at_k20(rng, C, mlp_dtype):
    layers = _synthetic_mlp(rng, [(2 * C, 16), (16, 16), (16, 24)])
    x = rng.normal(size=(2, 100, C)).astype(np.float32)
    kernel = jax_edgeconv.fused_edgeconv(jnp.asarray(x), _jax_fold(layers), k=20,
                                         mlp_dtype=getattr(jnp, mlp_dtype), interpret=True)
    launches = launches_by_variant(edgeconv)
    out = edgeconv.fused_edgeconv(torch.from_numpy(x), _torch_fold(layers), k=20,
                                  mlp_dtype=getattr(torch, mlp_dtype))
    assert launches_by_variant(edgeconv) == launches  # the CPU takes the plain version
    _assert_close_to_scale(out.numpy(), np.asarray(kernel))


@pytest.mark.parametrize('k', [17, 40])       # k = 20: the interpret-mode kernel above
@pytest.mark.parametrize('C', [3, 24])
def test_fused_edgeconv_reference_matches_jax(rng, k, C):
    layers = _synthetic_mlp(rng, [(2 * C, 16), (16, 24)])
    x = rng.normal(size=(2, 120, C)).astype(np.float32)
    ref = jax_edgeconv.fused_edgeconv_reference(jnp.asarray(x), _jax_fold(layers), k)
    out = edgeconv.fused_edgeconv_reference(torch.from_numpy(x), _torch_fold(layers), k)
    _assert_close_to_scale(out.numpy(), np.asarray(ref))


# ---- rows 8-9: knn_gather ----

@pytest.mark.parametrize('C', [3, 24])
def test_knn_gather_forward_and_backward_match_jax_at_k20(rng, C):
    x = rng.normal(size=(2, 90, C)).astype(np.float32)
    g = rng.normal(size=(2, 20, 90, C)).astype(np.float32)
    ref_nbr, ref_idx = jax_knn_gather(jnp.asarray(x), 20, True)
    _, vjp = jax.vjp(lambda v: jax_knn_gather(v, 20, True)[0], jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_(True)
    before = launches_by_variant(knn_gather)
    nbr, idx = knn_gather.knn_gather(xt, 20)
    nbr.backward(torch.from_numpy(g))
    assert launches_by_variant(knn_gather) == before  # the CPU takes the plain versions
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(nbr.detach().numpy(), np.asarray(ref_nbr), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), rtol=1e-4, atol=3e-4)


@pytest.mark.parametrize('k,C', [(17, 24), (40, 3)])
def test_knn_gather_forward_matches_jax(rng, k, C):
    x = rng.normal(size=(2, 80, C)).astype(np.float32)
    ref_nbr, ref_idx = jax_knn_gather(jnp.asarray(x), k, True)
    nbr, idx = knn_gather.knn_gather_reference(torch.from_numpy(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(nbr.numpy(), np.asarray(ref_nbr), rtol=1e-6, atol=1e-6)


# ---- routing of k = 17..128 on the card, and the bound ----

class _CudaStandIn:
    """Shape, dtype and device of a CUDA tensor, for routing checks
    without a card."""

    def __init__(self, *shape):
        self.shape = shape
        self.device = torch.device('cuda')
        self.dtype = torch.float32

    def dim(self):
        return len(self.shape)

    def contiguous(self):
        return self

    def is_contiguous(self):
        return True

    def float(self):
        return self

    def to(self, *args, **kwargs):
        return self

    def data_ptr(self):
        return 0


class _FakeLibrary:
    """A kernel library whose every entry returns 0 (success, or a scratch
    of 0 bytes) and records its arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        setattr(self, name, entry)
        return entry


@pytest.fixture()
def fake_card(monkeypatch):
    """Allocations on 'cuda' land on the CPU, the stream and the launchers'
    device guard are dummies, every library is a _FakeLibrary, and the plain
    versions raise."""
    lib = _FakeLibrary()
    real_empty = torch.empty
    monkeypatch.setattr(torch, 'empty',
                        lambda *shape, device=None, **kwargs: real_empty(*shape, **kwargs))
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, 'device', lambda device: contextlib.nullcontext())
    monkeypatch.setattr(_build, 'load_library', lambda name: lib)

    def plain(*args, **kwargs):
        raise AssertionError('a CUDA tensor reached the plain version')

    for module, names in ((knn, ('knn_reference', 'select_exact', 'select_ranked')),
                          (knn_gather, ('knn_gather_reference',
                                        'knn_gather_backward_reference')),
                          (edgeconv, ('fused_edgeconv_reference', 'edgeconv_select'))):
        for name in names:
            monkeypatch.setattr(module, name, plain)
    return lib


ROUTED_K = (17, 20, 32, 33, 64, 65, 100, 128)


@pytest.mark.parametrize('k', ROUTED_K)
@pytest.mark.parametrize('D,entry', [(3, 'knn_forward'), (16, 'knn_forward'),
                                     (150, 'knn_wide_forward')])
def test_knn_routes_every_k_to_the_kernel(fake_card, k, D, entry):
    knn.launches_by_shape.clear()
    ids = knn.knn(_CudaStandIn(2, 2000, D), k)
    assert tuple(ids.shape) == (2, 2000, k)
    assert [name for name, _ in fake_card.calls if name.endswith('_forward')] == [entry]
    assert k in fake_card.calls[-1][1]
    assert sum(launches_by_variant(knn).values()) == 1


@pytest.mark.parametrize('k', ROUTED_K)
@pytest.mark.parametrize('C', [3, 150])
def test_knn_gather_routes_every_k_to_the_kernels(fake_card, k, C):
    knn_gather.launches_by_shape.clear()
    nbr, idx = knn_gather.knn_gather_fwd(_CudaStandIn(2, 2000, C), k)
    assert tuple(nbr.shape) == (2, k, 2000, C) and tuple(idx.shape) == (2, 2000, k)
    stand_in_idx = _CudaStandIn(2, 2000, k)
    dx = knn_gather.knn_gather_bwd(stand_in_idx, _CudaStandIn(2, k, 2000, C))
    assert tuple(dx.shape) == (2, 2000, C)
    launched = [(name, args) for name, args in fake_card.calls if 'ward' in name]
    assert [name for name, _ in launched] == ['knn_gather_forward', 'knn_gather_backward']
    assert all(k in args for _, args in launched)
    assert launches_by_variant(knn_gather)['bwd'] == 1
    assert launches_by_variant(knn_gather)['fwd_small_c' if C <= 16 else 'fwd_wide_c'] == 1


@pytest.mark.parametrize('k', ROUTED_K)
@pytest.mark.parametrize('n_points', [2000, 10000])
def test_fused_edgeconv_routes_every_k_to_the_kernel(rng, monkeypatch, k, n_points):
    """The operator's CUDA kernel is the launch (a stand-in cannot pass the
    dispatcher, so the wrapper's call goes to that kernel directly), and
    the launch passes its checks at every k to 128: it reaches the weight
    packing that precedes the library call."""
    def plain(*args, **kwargs):
        raise AssertionError('a CUDA tensor reached the plain version')

    class Reached(Exception):
        pass

    def packed(*args):
        raise Reached

    monkeypatch.setattr(edgeconv, 'fused_edgeconv_reference', plain)
    monkeypatch.setattr(edgeconv, 'edgeconv_select', plain)
    monkeypatch.setattr(edgeconv, 'fused_edgeconv_op', edgeconv._fused_edgeconv_cuda)
    monkeypatch.setattr(edgeconv, '_pack_weight', packed)
    folded = _folded_on_stand_ins()
    with pytest.raises(Reached):
        edgeconv.fused_edgeconv(_CudaStandIn(2, n_points, 3), folded, k=k)


def _folded_on_stand_ins():
    vec = _CudaStandIn(8)
    return [(_CudaStandIn(6, 8), vec)], (vec, vec)


def test_k_129_raises_naming_the_bound(fake_card):
    """The standalone kNN stops at 128, as knn_pallas does; the fused layer
    and knn_gather take 128 < k <= N (tests/test_torch_wide_shapes.py)."""
    with pytest.raises(NotImplementedError, match='128'):
        knn.knn(_CudaStandIn(1, 200, 3), 129)
    with pytest.raises(NotImplementedError, match='128'):
        knn.knn(_CudaStandIn(1, 200, 150), 129)
    assert not any(name.endswith('ward') for name, _ in fake_card.calls)


def test_plain_versions_take_any_k_on_the_cpu(rng):
    """On the CPU the plain versions keep taking k past 128."""
    x = torch.from_numpy(rng.normal(size=(1, 200, 3)).astype(np.float32))
    assert tuple(knn.knn(x, 150).shape) == (1, 200, 150)
    nbr, idx = knn_gather.knn_gather(x, 150)
    assert tuple(idx.shape) == (1, 200, 150)
    out = edgeconv.fused_edgeconv(x, _torch_fold(_synthetic_mlp(rng, [(6, 8)])), k=150)
    assert tuple(out.shape) == (1, 200, 8)
