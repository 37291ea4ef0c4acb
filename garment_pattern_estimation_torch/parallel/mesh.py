"""Process-group set-up, device meshes and batch placement for data-parallel
training over `torch.distributed`.

Counterpart of garment_pattern_estimation_tpu/parallel/mesh.py:23-105. The
JAX package shards the batch axis of a `jax.sharding.Mesh` and lets XLA
insert the collectives; here each rank is a process with one card, the mesh
is a `torch.distributed.device_mesh.DeviceMesh` over the world of an
initialised process group, a rank holds its rows of the padded global batch
(`shard_batch`), and the collectives are written out (`collectives.py`).

    device = init_from_env()          # torchrun's RANK / WORLD_SIZE / LOCAL_RANK
    mesh = make_mesh()                # ('data',) over the whole world

`DataShard` is what the models see of a mesh: the data group, this rank's
place on it, the mean of per-rank statistics over the mesh, and this rank's
rows of a tensor drawn for the global batch; on a 2-D (data x points) mesh
also `PointsShard`, this rank's slice of every cloud's points and the
points group that sums over them.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..device import resolve_device
from .collectives import all_reduce_max, all_reduce_sum, gather_points, initialized

DATA_AXIS = 'data'
POINTS_AXIS = 'points'


def init_from_env(device=None) -> torch.device:
    """The default process group from the variables `torchrun` sets (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), and this rank's
    device. NCCL on the card, after `torch.cuda.set_device(LOCAL_RANK)`;
    gloo when `device` is the CPU. Without WORLD_SIZE in the environment,
    or with a group already initialised, no group is made: the device alone
    is resolved."""
    if initialized() or 'WORLD_SIZE' not in os.environ:
        return resolve_device(device)
    cpu = device is not None and torch.device(device).type == 'cpu'
    if not cpu:
        resolve_device(device)                       # raises without a card
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', 0)))
    dist.init_process_group('gloo' if cpu else 'nccl', init_method='env://')
    return resolve_device(device)


def _device_type():
    return 'cuda' if dist.get_backend() == 'nccl' else 'cpu'


def _whole_world(n, what):
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f'{what}: a mesh of {n} ranks needs a world of {n} processes, this '
                         f'one has {world} (torchrun --nproc_per_node={n} ...)')


def make_mesh(n=None):
    """1-D data-parallel mesh ('data',) over the world (`n`, if given, must
    be the world size)."""
    n = dist.get_world_size() if n is None else int(n)
    _whole_world(n, 'make_mesh')
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(DATA_AXIS,))


def make_mesh_2d(data, points):
    """2-D (data x points) mesh over the world, row-major: rank = d * points
    + p. The batch shards over 'data'; each data slice shards its clouds'
    point axis over 'points'."""
    _whole_world(data * points, 'make_mesh_2d')
    return init_device_mesh(_device_type(), (data, points),
                            mesh_dim_names=(DATA_AXIS, POINTS_AXIS))


def _axis(mesh, name):
    """(this rank's coordinate, size) on the mesh axis `name`."""
    dim = mesh.mesh_dim_names.index(name)
    return mesh.get_local_rank(dim), mesh.size(dim)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _is_array(x):
    return isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim > 0


def shard_batch(mesh, batch):
    """This rank's rows of every tensor or array of a (nested) batch whose
    leading axis divides by the mesh's data axis (callers pad first:
    `pad_batch_to_multiple`); other leaves pass through. On a 2-D mesh the
    3-D `features` (B, N, C) and the per-point ground truth
    (`ground_truth['segmentation']`, (B, N)) also keep this rank's point
    slice."""
    rank, size = _axis(mesh, DATA_AXIS)

    def rows(x):
        if not _is_array(x):
            return x
        if x.shape[0] % size:
            raise ValueError(f'shard_batch: {x.shape[0]} rows do not divide over {size} ranks')
        n = x.shape[0] // size
        return x[rank * n:(rank + 1) * n]

    placed = _tree_map(rows, batch)
    if POINTS_AXIS not in mesh.mesh_dim_names or not isinstance(placed, dict):
        return placed
    p, points = _axis(mesh, POINTS_AXIS)

    def point_slice(x):
        if x.shape[1] % points:
            raise ValueError(f'shard_batch: {x.shape[1]} points do not divide over '
                             f'{points} ranks')
        s = x.shape[1] // points
        return x[:, p * s:(p + 1) * s]

    features = placed.get('features')
    if _is_array(features) and features.ndim == 3:
        placed['features'] = point_slice(features)
    gt = placed.get('ground_truth')
    if isinstance(gt, dict) and _is_array(gt.get('segmentation')):
        placed['ground_truth'] = dict(gt, segmentation=point_slice(gt['segmentation']))
    return placed


@torch.no_grad()
def replicate(mesh, module):
    """Every parameter and buffer of `module` broadcast in place from the
    mesh's first rank."""
    src = int(mesh.mesh.flatten()[0])
    for tensor in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(tensor.data, src=src)
    return module


def pad_batch_to_multiple(batch, multiple):
    """Right-pad the leading axis of every tensor or array of the batch's
    size to a multiple of `multiple`, repeating the last sample. Returns
    (padded batch, real size)."""
    sizes = []
    _tree_map(lambda x: sizes.append(x.shape[0]) if _is_array(x) else None, batch)
    size = sizes[0]
    pad = (-size) % multiple
    if pad == 0:
        return batch, size

    def pad_rows(x):
        if not _is_array(x) or x.shape[0] != size:
            return x
        if isinstance(x, torch.Tensor):
            return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        return np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])

    return _tree_map(pad_rows, batch), size


class PointsShard:
    """This rank's slice of every cloud's points on a (data x points) mesh:
    the points group, `rank` on it and its `size`. Rank p holds the points
    [p S, (p + 1) S) of each of its clouds.

    Every collective here is one whose backward sums the cotangents over
    the points group: only one points rank backpropagates the loss, and a
    rank that uses the result for its own points holds a share of the
    cotangent (`collectives.py`)."""

    def __init__(self, mesh):
        self.group = mesh.get_group(mesh.mesh_dim_names.index(POINTS_AXIS))
        self.rank, self.size = _axis(mesh, POINTS_AXIS)

    def local(self, tensor):
        """This rank's points of (B, N, ...) clouds (N must divide)."""
        if tensor.shape[1] % self.size:
            raise ValueError(f'PointsShard: {tensor.shape[1]} points do not divide over '
                             f'{self.size} ranks')
        s = tensor.shape[1] // self.size
        return tensor[:, self.rank * s:(self.rank + 1) * s]

    def sizes(self, n):
        """Each rank's share of n items split in rank order as
        `torch.tensor_split` splits them (the first n % size ranks one more)."""
        return [n // self.size + (r < n % self.size) for r in range(self.size)]

    def span(self, n):
        """(start, stop) of this rank's share of n items (`sizes`)."""
        sizes = self.sizes(n)
        start = sum(sizes[:self.rank])
        return start, start + sizes[self.rank]

    def sum(self, value):
        """The sum over the points ranks of per-rank partial sums, on every
        rank."""
        return all_reduce_sum(value, self.group)

    def mean(self, total, rows):
        """The mean over every rank's rows from this rank's partial sum
        `total` over its `rows` rows: the sums and the row counts summed in
        one all-reduce, so shards of uneven size weigh by their rows."""
        both = self.sum(torch.cat([total.reshape(-1), total.new_tensor([float(rows)])]))
        return (both[:-1] / both[-1]).view_as(total)

    def max(self, value, dim):
        """The maximum over the axis `dim` of the ranks' parts of it
        (`collectives.all_reduce_max`: ties share the cotangent evenly,
        counted over every rank)."""
        return all_reduce_max(value, dim, self.group)

    def gather(self, tensor, sizes=None):
        """The whole (B, N, ...) clouds from every rank's (B, n_r, ...)
        points, in global order, on every rank; `sizes` the n_r (None: all
        equal). Its backward keeps this rank's points of the summed
        cotangents."""
        return gather_points(tensor, self.group, sizes)


class DataShard:
    """This rank's share of a batch sharded over a mesh's data axis: the
    data group, `rank` on it and its `size`. Every rank holds the same
    number of rows (`shard_batch` pads first), so a statistic over the
    global batch is the mean of the ranks' statistics (`mean`), and a
    tensor drawn for the global batch yields this rank's rows (`rows`).

    On a 2-D mesh `points` is the `PointsShard`, and the statistics group
    (`stats_group`, the group of `mean` and of the gradient sum) is the
    whole mesh: a per-point statistic is the mean over all ranks of each
    rank's (weighed by their rows where those are uneven), and a per-cloud
    one, or one of a stage that runs on whole gathered clouds, which the
    points ranks of a data slice hold alike, is too."""

    def __init__(self, mesh):
        dim = mesh.mesh_dim_names.index(DATA_AXIS)
        self.group = mesh.get_group(dim)
        self.rank, self.size = _axis(mesh, DATA_AXIS)
        self.points = PointsShard(mesh) if POINTS_AXIS in mesh.mesh_dim_names else None
        if self.points is None:
            self.stats_group, self.stats_size = self.group, self.size
        else:                 # make_mesh_2d spans the world: the default group
            self.stats_group, self.stats_size = None, self.size * self.points.size

    def mean(self, value, rows=None):
        """The mean over the statistics group's ranks of per-rank `value`s,
        differentiable (each rank's cotangents are summed). `rows` (on a
        2-D mesh): the rows this rank's value is the mean of. Where the
        ranks' counts differ (PointNet++'s centroids split unevenly over
        the points ranks) each value is weighed by its rows; where they are
        equal, or `rows` is None, by 1 / the group's size, so ranks that hold
        the same rows (the stages after a gather) give their value. The
        shares are summed in float64 and the mean rounded once to `value`'s
        dtype: an f32 sum rounds E[x^2] once more than one process's mean
        does, and a BatchNorm variance E[x^2] - E[x]^2 that cancels to a
        small share of E[x^2] carries that rounding into the whole
        gradient."""
        dtype, value = value.dtype, value.double()
        equal = value / self.stats_size
        if self.points is None or rows is None:
            return all_reduce_sum(equal, self.stats_group).to(dtype)
        counts = torch.tensor([rows, rows * rows], dtype=torch.float64, device=value.device)
        dist.all_reduce(counts, group=self.stats_group)
        total, squares = counts[0], counts[1]
        uneven = squares * self.stats_size != total * total
        weighted = value * (rows / total)
        return all_reduce_sum(torch.where(uneven, weighted, equal), self.stats_group).to(dtype)

    def rows(self, tensor):
        """This rank's rows of a tensor of the global batch."""
        n = tensor.shape[0] // self.size
        return tensor[self.rank * n:(self.rank + 1) * n]
