"""The port's wide-D kNN (D > 16) against the JAX package's: the
plain port (the CPU path of `ops.knn.knn`) against `knn_pallas` with its
`_knn_kernel` in interpret mode, forced onto small tiles (tile_m=16,
tile_n=64) so its per-tile extraction and its merges of tiles run, on
clouds whose point count is not a multiple of the tile.

Both compute q_norm + k_norm - 2 * cross from the same six split products
and rank by the exact f32 value with ties to the lower index, but each
sums the products over D in its own order (XLA's dot against the CPU
matmul), so ids may differ at near ties: every slot where they differ must
hold two neighbours whose f64 squared distances to the query differ by at
most 2^-18 of the squared norms. On integer coordinates every product and
sum is exact, and the ids are held equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from garment_pattern_estimation_tpu.ops.knn import knn_pallas
from garment_pattern_estimation_torch.ops import knn, launches_by_variant

torch.set_num_threads(1)

NEAR_TIE = 2.0 ** -18


def _jax_ids(x, k):
    return np.asarray(knn_pallas(jnp.asarray(x), k, tile_m=16, tile_n=64, interpret=True))


def _assert_equal_but_near_ties(x, ids, ref):
    """Slot by slot, the f64 distances of the two id lists agree within
    2^-18 of the query's and the cloud's largest squared norms."""
    x = x.astype(np.float64)
    b = np.arange(x.shape[0])[:, None, None]

    def dists(i):
        return ((x[b, i] - x[:, :, None]) ** 2).sum(-1)

    norms = (x ** 2).sum(-1)
    bound = NEAR_TIE * (norms + norms.max(axis=-1, keepdims=True))[..., None]
    differ = ids != ref
    assert (np.abs(dists(ids) - dists(ref)) <= bound)[differ].all()
    assert (ids[..., 0] == np.arange(x.shape[1])).all()              # self in slot 0


@pytest.mark.parametrize('shape,k', [
    ((2, 100, 17), 5),     # the narrowest wide D, two column tiles
    ((1, 200, 24), 8),     # the kernel's largest k, four column tiles
    ((2, 130, 150), 5),    # the attention model's conv1 width
    ((1, 64, 150), 3),     # one tile exactly
    ((1, 70, 256), 2),     # the widest D the kernel takes
])
def test_knn_wide_matches_jax_pallas(rng, shape, k):
    x = rng.normal(size=shape).astype(np.float32)
    before = launches_by_variant(knn)
    ids = knn.knn(torch.from_numpy(x), k)
    assert launches_by_variant(knn) == before  # the CPU takes the plain version
    assert ids.dtype == torch.int64 and tuple(ids.shape) == (*shape[:2], k)
    ref = _jax_ids(x, k)
    assert (ids.numpy() == ref).mean() >= 0.99
    _assert_equal_but_near_ties(x, ids.numpy(), ref)


@pytest.mark.parametrize('D', [17, 40])
def test_knn_wide_lattice_and_duplicates_match_jax_exactly(rng, D):
    """Coordinates in {-2..2} with every point twice: all distances are
    exact integers, many tie, and each point's duplicate is at 0. Ids equal
    the JAX kernel's; among equal distances the lower index comes first;
    self stays in slot 0 with its duplicate in slot 1."""
    half = rng.integers(-2, 3, size=(2, 70, D)).astype(np.float32)
    x = np.concatenate([half, half], axis=1)                      # point i + 70 = point i
    ids = knn.knn(torch.from_numpy(x), 5).numpy()
    np.testing.assert_array_equal(ids, _jax_ids(x, 5))
    n = np.arange(140)
    np.testing.assert_array_equal(ids[..., 0], np.broadcast_to(n, (2, 140)))
    np.testing.assert_array_equal(ids[..., 1], np.broadcast_to((n + 70) % 140, (2, 140)))
    d = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    got = np.take_along_axis(d, ids[..., 1:], axis=-1)
    assert (np.diff(got, axis=-1) >= 0).all()
    same = np.diff(got, axis=-1) == 0
    assert same.any() and (np.diff(ids[..., 1:], axis=-1)[same] > 0).all()


def test_select_exact_ranks_negative_and_signed_zero_distances():
    """Unclamped distances: a negative one ranks first, -0 ties with +0
    (the lower column first), and every value keeps its full f32 order."""
    row = [0.0, -0.0, 0.0, -1e-3, 2.0, 1e-30, -1e-30, 2.0000002]
    dists = torch.tensor(row).repeat(8, 1)[None]                  # (1, 8, 8)
    ids = knn.select_exact(dists, 8)
    assert ids[0, 0].tolist() == [0, 3, 6, 1, 2, 5, 4, 7]         # query 0: self first
    assert ids[0, 3].tolist() == [3, 6, 0, 1, 2, 5, 4, 7]         # self column skipped
    bits = knn.order_preserving_bits(torch.tensor([-2.0, -1.0, -1e-30, -0.0, 0.0, 1e-30, 1.0]))
    assert bits[3] == bits[4] == 0 and (bits.diff()[[0, 1, 2, 4, 5]] > 0).all()


def test_knn_wide_negative_distance_ranks_first(rng):
    """Near duplicates far from the origin: q_norm + k_norm - 2 cross
    cancels to a computed distance below 0 for some pairs, and that pair
    ranks before every positive one, as in the JAX kernel."""
    base = (rng.normal(size=(1, 40, 150)) * 30 + 300).astype(np.float32)
    x = np.concatenate([base, base + (rng.normal(size=base.shape) * 1e-5).astype(np.float32)],
                       axis=1)
    dists = knn.wide_sq_dists(torch.from_numpy(x))
    dists.diagonal(dim1=1, dim2=2).fill_(float('inf'))
    negative = (dists.amin(dim=-1) < 0)[0]
    assert negative.any()
    ids = knn.knn(torch.from_numpy(x), 3)
    rows = negative.nonzero()[:, 0]
    assert torch.equal(ids[0, rows, 1], dists[0, rows].argmin(dim=-1))
    _assert_equal_but_near_ties(x, ids.numpy(), _jax_ids(x, 3))


def test_knn_wide_k_is_cut_to_n(rng):
    x = torch.from_numpy(rng.normal(size=(2, 4, 24)).astype(np.float32))
    ids = knn.knn(x, 8)
    assert tuple(ids.shape) == (2, 4, 4)
    assert torch.equal(ids.sort(dim=-1).values, torch.arange(4).expand(2, 4, 4))
    assert torch.equal(knn.knn(x, 1), torch.arange(4).expand(2, 4)[..., None])


def test_knn_wide_refuses_other_devices():
    with pytest.raises(ValueError, match='unsupported device'):
        knn.knn(torch.zeros(1, 8, 150, device='meta'), 3)


class _CudaStandIn:
    """Shape and device of a CUDA tensor, for routing checks without a card."""

    def __init__(self, *shape):
        self.shape = shape
        self.device = torch.device('cuda')

    def dim(self):
        return len(self.shape)


def _no_plain(monkeypatch):
    def plain(*args):
        raise AssertionError('a CUDA tensor reached the plain version')

    for name in ('knn_reference', 'select_exact', 'wide_sq_dists', 'select_ranked'):
        monkeypatch.setattr(knn, name, plain)


@pytest.mark.parametrize('D', [17, 150, 256])
def test_knn_wide_cuda_tensor_never_takes_the_plain_version(monkeypatch, D):
    _no_plain(monkeypatch)
    launched = []
    monkeypatch.setattr(knn, '_launch_wide', lambda *args: launched.append(args))
    monkeypatch.setattr(knn, '_launch', lambda *args: pytest.fail('small-D kernel'))
    knn.knn(_CudaStandIn(2, 10000, D), 5)
    assert len(launched) == 1


def test_knn_wide_past_256_takes_the_wide_kernel_on_the_card_path(monkeypatch):
    """D = 257 (past one 256-feature stage) goes to the wide-D kernel as
    D = 256 does; tile_n stays a small-D option."""
    _no_plain(monkeypatch)
    launched = []
    monkeypatch.setattr(knn, '_launch_wide', lambda *args: launched.append(args))
    knn.knn(_CudaStandIn(1, 64, 257), 5)
    assert len(launched) == 1
    with pytest.raises(ValueError, match='tile_n'):
        knn.knn(_CudaStandIn(1, 64, 150), 5, tile_n=64)
