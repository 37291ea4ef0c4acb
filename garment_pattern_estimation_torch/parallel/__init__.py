"""Data parallelism over `torch.distributed` and the points-sharded ring:
the port's counterpart of garment_pattern_estimation_tpu/parallel/.

    mesh.py         process-group set-up from torchrun's environment, device
                    meshes, padding, sharding and replication of a batch
                    and a module, `DataShard`, `PointsShard`
    collectives.py  autograd-aware all-reduce, row gather and ring shift;
                    the gradient sum; first-rank helpers
    ring.py         ring kNN + gather, the points-sharded EdgeConv and
                    encoder step
    dryrun.py       `dryrun_multichip(n, device)`: n ranks (n cards, or
                    gloo CPU processes with device='cpu') through one DP
                    step, the sharded encoder, the ring and a 2-D step

`Trainer.fit` trains over W processes, one card each, when a process group
is initialised (`torchrun --nproc_per_node=W -m
garment_pattern_estimation_torch.cli.train ...`): over a data mesh, or with
`trainer.mesh: {data: d, points: p}` (d p = W) over a data x points mesh,
each cloud's points sharded over the points ranks.
"""

from .collectives import (
    all_gather_rows, all_reduce_sum, barrier, broadcast_object, is_first_rank, ring_shift,
    sum_gradients)
from .mesh import (
    DATA_AXIS, POINTS_AXIS, DataShard, init_from_env, make_mesh, make_mesh_2d,
    pad_batch_to_multiple, replicate, shard_batch)
from .ring import make_points_mesh, ring_edgeconv, ring_knn_gather, sharded_encoder_step

__all__ = [
    'DATA_AXIS', 'POINTS_AXIS', 'DataShard', 'all_gather_rows', 'all_reduce_sum', 'barrier',
    'broadcast_object', 'init_from_env', 'is_first_rank', 'make_mesh', 'make_mesh_2d',
    'make_points_mesh', 'pad_batch_to_multiple', 'replicate', 'ring_edgeconv',
    'ring_knn_gather', 'ring_shift', 'shard_batch', 'sharded_encoder_step', 'sum_gradients',
]
