"""The yardstick's counts against hand counts at small shapes."""
import json

import pytest

from benchmark import common, yardstick as y


def test_pairs_counts_unordered_pairs():
    assert y.pairs(2, 4) == 12              # 2 clouds x C(4, 2)


def test_fused_edgeconv_small_and_wide():
    # distances: 2 C per unordered pair, at any C; MLP 2 B N k (2C*h + h*f)
    ops, n_bytes = y.fused_edgeconv(1, 4, 3, 2, [5, 7])
    assert ops == 2 * 3 * 6 + 2 * 4 * 2 * (6 * 5 + 5 * 7)
    assert n_bytes == 4 * 4 * (3 + 7) + (2 * 6 * 5 + 4 * 5) + (2 * 5 * 7 + 4 * 7) + 8 * 7
    ops, _ = y.fused_edgeconv(1, 4, 20, 2, [5])
    assert ops == 2 * 20 * 6 + 2 * 4 * 2 * 40 * 5


def test_knn_and_gather_counts():
    assert y.knn(2, 3, 3, 2) == (2 * 3 * 6, 4 * 2 * 3 * 5)
    assert y.knn_wide(1, 3, 20, 2) == (2 * 20 * 3, 4 * 3 * 22)
    assert y.knn_gather_fwd(1, 3, 3, 2) == (2 * 3 * 3, 4 * (9 + 18 + 6))
    assert y.knn_gather_fwd(1, 3, 20, 2)[0] == 2 * 20 * 3
    assert y.knn_gather_bwd(1, 3, 4, 2) == (1 * 3 * 4, 4 * (24 + 6 + 12))


@pytest.mark.parametrize('cost', ['fused_edgeconv', 'knn', 'knn_wide', 'knn_gather_fwd'])
@pytest.mark.parametrize('C', [3, 150])
def test_every_distance_counts_as_the_model_does(cost, C):
    """A kernel's distances are the share of `model_operations`' count that
    its layer needs: one 2 C product per unordered pair, whatever the
    kernel's split products."""
    B, N, k = 2, 50, 5
    ops, _ = y.COSTS[cost](B, N, C, k, [C])
    mlp = 2.0 * B * N * k * (2 * C * C) if cost == 'fused_edgeconv' else 0.0
    assert ops - mlp == y.distances(B, N, C) == 2.0 * C * B * N * (N - 1) / 2


def test_bound_is_the_larger_time():
    assert y.bound_seconds(y.PEAK_FLOPS, 0) == pytest.approx(1.0)
    assert y.bound_seconds(0, 2 * y.PEAK_BYTES) == pytest.approx(2.0)


def test_model_operations_by_hand():
    """A tiny baseline: one conv layer, k = 2, widths [4], LSTMs of one layer."""
    config = json.loads((common.HERE / 'configs' / 'baseline.json').read_text())
    nn = dict(config['NN'], conv_depth=1, k_neighbors=2, EConv_hidden_depth=0, EConv_feature=4,
              skip_connections=False, pattern_encoding_size=5, pattern_hidden_size=5,
              pattern_n_layers=1, panel_encoding_size=6, panel_hidden_size=6, panel_n_layers=1)
    data = dict(config['data'], max_pattern_len=2, max_panel_len=3)
    tiny = dict(config, NN=nn, data=data)
    B, N = 1, 3
    edge = 2 * B * N * 2 * 6 * 4
    dist = 2 * 3 * 3
    head = 2 * B * 4 * 5
    pattern = 2 * B * 2 * 5 * 20 * 2                  # input and recurrent products, 2 steps
    to_panels = 2 * B * 2 * 5 * 6
    panel = 2 * 2 * 3 * 6 * 24 * 2
    out = 2 * 2 * 3 * 6 * 8
    place = 2 * 2 * 6 * 7
    serve = edge + dist + head + pattern + to_panels + panel + out + place
    assert y.model_operations(tiny, B, N, train=False) == serve
    train = 2 * edge + dist + 3 * (serve - edge - dist)
    assert y.model_operations(tiny, B, N, train=True) == train
