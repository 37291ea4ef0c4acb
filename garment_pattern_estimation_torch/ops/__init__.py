"""Ops of the port: the fused EdgeConv and knn_gather (CUDA kernels + plain
versions), the standalone kNN (`knn.knn`, CUDA kernel + plain version, and
the ranking helpers it shares with the fused layer), sparsemax, masked
pools. `knn` names the module, so that `ops.knn.knn(points, k)` and the
module's helpers stay reachable under one name."""
from . import knn

__all__ = ['knn', 'launches_by_variant']


def launches_by_variant(module):
    """{variant: count} of an ops module's kernel launches (`edgeconv`,
    `knn`, `knn_gather`), from its `launches_by_shape`: every variant of
    its `VARIANTS`, and a two-launch layer's pair (`_select` with `_mlp` or
    `_rows`) counted once, under its variant."""
    counts = dict.fromkeys(module.VARIANTS, 0)
    for (variant, *_), n in module.launches_by_shape.items():
        if not variant.endswith(('_mlp', '_rows')):
            counts[variant.removesuffix('_select')] += n
    return counts
