"""The port's standalone kNN against the JAX package's: the plain port (the
CPU path of `ops.knn.knn`) against `knn_pallas` with its direct small-D
kernel `_knn_kernel_direct` in interpret mode, forced onto small column
tiles (tile_m=16, tile_n=64) so its per-tile packed extraction and its
merges of tiles on (quantized distance, global id) run, on clouds whose
point count is not a multiple of the tile.

Ids are held exactly: both sum the per-dimension squares in dimension order
at f32, quantize to the same 21 bits and break ties to the lower index. On
an integer lattice many distances tie exactly, which pins the tie rule.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from garment_pattern_estimation_tpu.ops.knn import knn_pallas
from garment_pattern_estimation_torch.ops import edgeconv, knn

torch.set_num_threads(1)


def _jax_ids(x, k):
    return np.asarray(knn_pallas(jnp.asarray(x), k, tile_m=16, tile_n=64, interpret=True))


@pytest.mark.parametrize('shape,k', [
    ((2, 150, 3), 5),      # the xyz layer's k, three column tiles
    ((1, 130, 8), 8),      # the kernel's largest k
    ((1, 100, 16), 3),     # the widest direct D
    ((1, 70, 3), 2),
])
def test_knn_matches_jax_pallas_multi_tile(rng, shape, k):
    x = rng.normal(size=shape).astype(np.float32)
    before = dict(knn.launches)
    ids = knn.knn(torch.from_numpy(x), k)
    assert knn.launches == before            # the CPU takes the plain version
    assert ids.dtype == torch.int64 and tuple(ids.shape) == (*shape[:2], k)
    np.testing.assert_array_equal(ids.numpy(), _jax_ids(x, k))


def test_knn_lattice_ties_go_to_the_lower_index(rng):
    """Coordinates in {-2..2}: most distances tie exactly, and many points
    coincide, so the order is decided by the tie rule alone."""
    x = rng.integers(-2, 3, size=(2, 140, 3)).astype(np.float32)
    ids = knn.knn(torch.from_numpy(x), 5).numpy()
    np.testing.assert_array_equal(ids, _jax_ids(x, 5))
    d = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    got = np.take_along_axis(d, ids[..., 1:], axis=-1)
    assert (np.diff(got, axis=-1) >= 0).all()
    # among equal distances the lower index comes first
    same = np.diff(got, axis=-1) == 0
    assert same.any() and (np.diff(ids[..., 1:], axis=-1)[same] > 0).all()


@pytest.mark.parametrize('shape', [(2, 120, 3), (1, 90, 16)])
def test_knn_reference_equals_the_fused_layers_selection(rng, shape):
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    ids, _ = edgeconv.edgeconv_select(x, 5)
    assert torch.equal(knn.knn_reference(x, 5), ids)


def test_knn_k_is_cut_to_n(rng):
    x = torch.from_numpy(rng.normal(size=(1, 4, 3)).astype(np.float32))
    ids = knn.knn(x, 8)
    assert tuple(ids.shape) == (1, 4, 4)
    assert torch.equal(ids.sort(dim=-1).values, torch.arange(4).expand(1, 4, 4))


def test_knn_refuses_other_devices():
    with pytest.raises(ValueError, match='unsupported device'):
        knn.knn(torch.zeros(1, 8, 3, device='meta'), 3)


class _CudaStandIn:
    """Shape and device of a CUDA tensor, for routing checks without a card."""

    def __init__(self, *shape):
        self.shape = shape
        self.device = torch.device('cuda')

    def dim(self):
        return len(self.shape)


def test_knn_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    def plain(*args):
        raise AssertionError('a CUDA tensor reached the plain version')

    launched = []
    monkeypatch.setattr(knn, 'knn_reference', plain)
    monkeypatch.setattr(knn, 'select_ranked', plain)
    monkeypatch.setattr(knn, '_launch', lambda *args: launched.append(args))
    knn.knn(_CudaStandIn(2, 10000, 3), 5)
    assert len(launched) == 1
