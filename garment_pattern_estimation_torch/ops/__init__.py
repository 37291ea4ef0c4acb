"""Ops of the port: the fused EdgeConv and knn_gather (CUDA kernels + plain
versions), the standalone kNN (`knn.knn`, CUDA kernel + plain version, and
the ranking helpers it shares with the fused layer), sparsemax, masked
pools. `knn` names the module, so that `ops.knn.knn(points, k)` and the
module's helpers stay reachable under one name."""
from . import knn

__all__ = ['knn']
