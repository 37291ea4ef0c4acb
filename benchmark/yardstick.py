"""Operations and bytes, counted from shapes, and the chip's peaks: what
the rooflines and the model's share of the peak divide by.

Peak rule. Every multiply-add counted is taken at the H100 SXM's dense
bf16 tensor-core peak, and every byte at its HBM3 bandwidth (NVIDIA's data
sheet). The port computes f32-exact products on bf16 tensor cores (the
split-term distances, knn_gather's two value chunks) and its served edge
MLP runs on bf16 by design, so only the bf16 peak bounds every
implementation of the same mathematics; a count at the f32 peak would let
a sound redesign read above 100%.

The per-kernel counts follow chip_smoke.py (`bound`, `knn_bound`,
`knn_wide_bound`, `gather_bound`), frozen here, except for the distances:
each is counted as what the inputs need, one product of 2 C operations per
unordered pair of a cloud (`pairs`), as `model_operations` counts it, and
not as the split products or the sub-mul-add that a kernel chooses. Each
input byte read once, each output byte written once; selection compares
not counted.
"""
from __future__ import annotations

PEAK_FLOPS = 989e12          # dense bf16, H100 SXM
PEAK_BYTES = 3.35e12         # HBM3, H100 SXM


def pairs(B, N):
    """Unordered pairs of distinct points in B clouds of N: every distance
    the kernels compute is symmetric."""
    return B * N * (N - 1) / 2.0


def distances(B, N, C):
    """Operations of every squared distance in B clouds of N points of C
    dimensions: one product of C multiply-adds per unordered pair."""
    return 2.0 * C * pairs(B, N)


def fused_edgeconv(B, N, C, k, widths):
    """(operations, bytes) of one fused EdgeConv layer: the distances, the
    edge MLP over B N k edges; x read, the output written, the bf16 weights,
    f32 biases and the final affine."""
    dims = [2 * C, *widths]
    mlp = 2.0 * B * N * k * sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    dist = distances(B, N, C)
    n_bytes = 4.0 * B * N * (C + widths[-1]) \
        + sum(2 * i * o + 4 * o for i, o in zip(dims[:-1], dims[1:])) + 8 * widths[-1]
    return dist + mlp, n_bytes


def knn(B, N, C, k, widths=None):
    """(operations, bytes) of the small-D kNN: the distances; points read,
    int32 ids written."""
    return distances(B, N, C), 4.0 * B * N * (C + k)


def knn_wide(B, N, C, k, widths=None):
    """(operations, bytes) of the wide-D kNN: the distances; points read,
    int32 ids written."""
    return distances(B, N, C), 4.0 * B * N * (C + k)


def knn_gather_fwd(B, N, C, k, widths=None):
    """(operations, bytes) of knn_gather's forward: the distances; x read,
    the (B, k, N, C) rows and the ids written."""
    return distances(B, N, C), 4.0 * (B * N * C + B * k * N * C + B * N * k)


def knn_gather_bwd(B, N, C, k, widths=None):
    """(operations, bytes) of knn_gather's backward: the (k - 1) B N C
    additions; the rows' cotangents and the ids read, dx written."""
    return 1.0 * B * (k - 1) * N * C, 4.0 * (B * k * N * C + B * N * k + B * N * C)


COSTS = {f.__name__: f for f in (fused_edgeconv, knn, knn_wide, knn_gather_fwd, knn_gather_bwd)}


def bound_seconds(operations, n_bytes):
    """The least time on the chip: the larger of the two bounds."""
    return max(operations / PEAK_FLOPS, n_bytes / PEAK_BYTES)


def edge_widths(nn):
    return [nn['EConv_hidden']] * nn['EConv_hidden_depth'] + [nn['EConv_feature']]


def model_operations(config, batch, points, train):
    """Operations of one served forward (`train` False) or one training
    step, counted as what the inputs need: 2 per multiply-add of every
    Dense, LSTM and edge-MLP product, and one product per unordered pair
    for each kNN's distances (2 C). A training step takes each product three
    times (forward, and the two gradients), the first edge layer of the
    first EdgeConv twice (its input needs no gradient) and the distances
    once. Elementwise work is not counted."""
    nn, data = config['NN'], config['data']
    B, N, k = batch, points, nn['k_neighbors']
    P, L = data['max_pattern_len'], data['max_panel_len']
    widths = edge_widths(nn)
    times = 3.0 if train else 1.0
    ops, c_in = 0.0, 3
    for layer in range(nn['conv_depth']):
        dims = [2 * c_in, *widths]
        products = [2.0 * B * N * k * i * o for i, o in zip(dims[:-1], dims[1:])]
        first = (2.0 if layer == 0 else 3.0) if train else 1.0
        ops += first * products[0] + times * sum(products[1:])
        ops += distances(B, N, c_in)
        c_in = widths[-1]
    feature = c_in + (3 if nn['skip_connections'] else 0)

    def dense(rows, fan_in, fan_out):
        return times * 2.0 * rows * fan_in * fan_out

    def lstm(rows, steps, fan_in, hidden, layers):
        return sum(dense(rows * steps, fan_in if l == 0 else hidden, 4 * hidden)
                   + dense(rows * steps, hidden, 4 * hidden) for l in range(layers))

    E, H = nn['panel_encoding_size'], nn['panel_hidden_size']
    if config['model'] == 'GarmentSegmentPattern3D':
        mlp = [feature, feature, feature, P]
        ops += sum(dense(B * N, i, o) for i, o in zip(mlp[:-1], mlp[1:]))
        ops += times * 2.0 * B * N * P * feature                 # the attention pooling
        ops += dense(B * P, feature, E)
    else:
        pE, pH = nn['pattern_encoding_size'], nn['pattern_hidden_size']
        ops += dense(B, feature, pE)
        ops += lstm(B, P, pE, pH, nn['pattern_n_layers']) + dense(B * P, pH, E)
    out = data['element_size'] + nn['stitch_tag_dim'] + 1
    ops += lstm(B * P, L, E, H, nn['panel_n_layers']) + dense(B * P * L, H, out)
    ops += dense(B * P, E, data['rotation_size'] + data['translation_size'])
    return ops
