"""`dryrun_multichip(n)`: n ranks through the port's parallel paths on tiny
shapes, and `spawn`, which starts such ranks.

Counterpart of __graft_entry__.py:100-250 (`dryrun_multichip`): where that
one jits the training step over an n-device mesh (provisioning a virtual
CPU mesh when fewer devices are visible), this one starts n processes, one
card each over NCCL, or n CPU processes over gloo when the caller asks for
the CPU, and checks in each:

  1. one data-parallel `Trainer.train_step` on the tiny attention model
     (batch 2n, 32 points): a finite loss, and every rank's parameters
     identical after the step;
  2. `sharded_encoder_step` over a points mesh of the n ranks against the
     same layers unsharded in plain f32 (`_edgeconv_plain`), within 2e-4;
  3. for n >= 4 (even), the ring on a 2 x n/2 data x points mesh, as 2;
  4. for n >= 4 (even), the training step of 1. on that 2 x n/2 mesh
     (`trainer.mesh: {data: 2, points: n/2}`), and the same step of the
     graph-pooled model (`_NN_POOLED`: the first pool gathers the points
     ranks' shares): each loss, at the same weights on the same batch,
     within 1e-3 of the data-parallel step's (__graft_entry__.py:196-216's
     bar).

    python -m garment_pattern_estimation_torch.parallel.dryrun 2               # 2 cards
    python -m garment_pattern_estimation_torch.parallel.dryrun 2 --device cpu  # gloo
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

RTOL = 2e-4       # the JAX ring tests' bar: f32 sums in another order

_DATA = {
    'element_size': 4, 'rotation_size': 4, 'translation_size': 3,
    'max_panel_len': 6, 'max_pattern_len': 5, 'max_num_stitches': 4,
    'explicit_stitch_tags': False,
    'standardize': {
        'gt_shift': {'outlines': [0, 0, 0.1489, 0.0564], 'rotations': [-0.7071, -0.9239, -1, 0],
                     'translations': [-55.255, -20.001, -17.087],
                     'stitch_tags': [-59.991, -78.124, -52.956]},
        'gt_scale': {'outlines': [25.268, 31.299, 0.2677, 0.2352],
                     'rotations': [1.7071, 1.9239, 1.7071, 1],
                     'translations': [109.589, 98.279, 37.847],
                     'stitch_tags': [119.983, 156.038, 105.926]},
    },
}
_NN = {'panel_encoding_size': 16, 'panel_hidden_size': 16, 'panel_n_layers': 1,
       'pattern_encoding_size': 16, 'EConv_hidden': 8, 'EConv_feature': 8,
       'EConv_hidden_depth': 2, 'k_neighbors': 3, 'conv_depth': 1,
       'skip_connections': True, 'global_pool': 'mean', 'local_attention': True}
# graph pooling: conv0 on the ring, then a gather, the pools and conv1 on
# whole clouds
_NN_POOLED = dict(_NN, graph_pooling=True, skip_connections=False, conv_depth=2,
                  pool_ratio=0.5)
_LOSS = {'loss_components': ['shape', 'loop', 'rotation', 'translation'],
         'quality_components': [], 'panel_order_inariant_loss': False,
         'panel_origin_invariant_loss': False}


def _rank_main(rank, n, store, backend, fn, args):
    torch.set_num_threads(1)
    os.environ['LOCAL_RANK'] = str(rank)
    if backend == 'nccl':
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, store=dist.FileStore(store, n), rank=rank, world_size=n)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def spawn(fn, n, *args, backend='gloo'):
    """Run `fn(*args)` in n new processes joined in a process group (a
    FileStore in a temporary directory: no port to collide with), each
    with one thread; 'nccl' gives rank r card r. Raises if a rank raises.
    `fn` must be importable from a module (the processes are spawned)."""
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(n, os.path.join(tmp, 'store'), backend, fn, args),
                           nprocs=n, start_method='spawn', join=True)


def _batch(B, N, P, L, seed=0):
    rng = np.random.default_rng(seed)
    gt = {'outlines': rng.normal(size=(B, P, L, 4)), 'rotations': rng.normal(size=(B, P, 4)),
          'translations': rng.normal(size=(B, P, 3)),
          'num_edges': np.full((B, P), 4), 'num_panels': np.full((B,), P),
          'empty_panels_mask': np.zeros((B, P), bool), 'stitches': np.zeros((B, 2, 4)),
          'num_stitches': np.ones((B,)), 'free_edges_mask': np.ones((B, P, L), bool),
          'stitch_tags': rng.normal(size=(B, P, L, 3))}
    cast = {'num_edges': torch.int32, 'num_panels': torch.int32, 'stitches': torch.int32,
            'num_stitches': torch.int32}
    return {'features': torch.from_numpy(rng.normal(size=(B, N, 3)).astype(np.float32)),
            'ground_truth': {k: torch.from_numpy(v).to(cast.get(k, torch.float32))
                             if v.dtype != bool else torch.from_numpy(v)
                             for k, v in gt.items()}}


def _edgeconv_plain(mlp, x, k):
    """One unsharded dynamic EdgeConv layer in plain f32: the ring's
    ranking (quantized norm-expansion distances, ties to the lower id, self
    first) on the whole cloud, the edge MLP and the max over the slots."""
    from ..ops.knn import pairwise_sq_dists, select_ranked
    from ..ops.pooling import gather_neighbors

    nbr = gather_neighbors(x, select_ranked(torch.clamp_min(pairwise_sq_dists(x, x), 0.0), k))
    center = x[:, :, None, :].expand_as(nbr)
    return torch.amax(mlp(torch.cat([center, nbr - center], dim=-1)), dim=2)


def _check_close(name, ours, ref):
    gap = float((ours.cpu() - ref).abs().max())
    bar = RTOL * max(float(ref.abs().max()), 1.0)
    if not gap <= bar:
        raise AssertionError(f'dryrun_multichip::{name} off the unsharded layers by {gap} '
                             f'(bar {bar})')


def _dryrun_rank(backend):
    from ..models import build_model
    from ..models.blocks import MLP
    from ..train import Trainer
    from .mesh import make_mesh, make_mesh_2d
    from .ring import make_points_mesh, sharded_encoder_step

    n, rank = dist.get_world_size(), dist.get_rank()
    device = torch.device('cuda', rank) if backend == 'nccl' else torch.device('cpu')

    # 1. one data-parallel training step
    setup = {'batch_size': 2 * n, 'epochs': 1, 'learning_rate': 1e-3, 'optimizer': 'Adam'}

    def train_step(nn_config, mesh_config):
        """(loss, model) of one step from seed 0's weights over `trainer.mesh`
        `mesh_config` (None: a data mesh of the world)."""
        model = build_model('GarmentSegmentPattern3D', _DATA, nn_config, _LOSS, device=device,
                            seed=0)
        trainer = Trainer(dict(setup, mesh=mesh_config), device=device)
        trainer.make_optimizer(model, 1)
        trainer.use_mesh(model, trainer.mesh_from_setup() if mesh_config else make_mesh())
        return trainer.train_step(model, _batch(2 * n, 32, 5, 6), 0)[0], model

    loss, model = train_step(_NN, None)
    if not torch.isfinite(loss):
        raise AssertionError(f'dryrun_multichip::non-finite loss {float(loss)}')
    flat = torch.cat([p.detach().reshape(-1) for p in model.module.parameters()])
    every = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(every, flat)
    if not all(torch.equal(every[0], other) for other in every[1:]):
        raise AssertionError('dryrun_multichip::the ranks\' parameters differ after the step')

    # 2. the ring EdgeConv stack over a points mesh against the unsharded layers
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16 * n, 3, generator=gen)
    mlps = [MLP([6, 16, 12]), MLP([24, 16, 8])]
    for mlp in mlps:
        mlp.load_state_dict(_random_mlp_state(mlp, gen))
        mlp.eval()
    with torch.no_grad():
        h_ref = _edgeconv_plain(mlps[1], _edgeconv_plain(mlps[0], x, 4), 4)
        h, pooled = sharded_encoder_step(make_points_mesh(), [m.to(device) for m in mlps],
                                         x.to(device), 4)
    S = x.shape[1] // n
    _check_close('ring features', h, h_ref[:, rank * S:(rank + 1) * S])
    _check_close('ring pool', pooled, h_ref.mean(dim=1))

    # 3. the ring within each data slice of a 2 x n/2 mesh
    if n >= 4 and n % 2 == 0:
        mesh = make_mesh_2d(2, n // 2)
        x = torch.randn(4, 8 * n, 3, generator=gen)
        with torch.no_grad():
            ref = _edgeconv_plain(mlps[0].cpu(), x, 4)
            h, pooled = sharded_encoder_step(mesh, [mlps[0].to(device)], x.to(device), 4,
                                             data_axis='data')
        d, p = divmod(rank, n // 2)
        S = x.shape[1] // (n // 2)
        _check_close('2-D ring features', h, ref[2 * d:2 * d + 2, p * S:(p + 1) * S])
        _check_close('2-D ring pool', pooled, ref[2 * d:2 * d + 2].mean(dim=1))

        # 4. the training step of 1., and the graph-pooled model's, on the 2-D mesh
        mesh2d = {'data': 2, 'points': n // 2}
        pooled_loss = train_step(_NN_POOLED, None)[0]
        for name, nn_config, dp_loss in (('', _NN, loss), (' graph-pooled', _NN_POOLED,
                                                            pooled_loss)):
            loss2 = train_step(nn_config, mesh2d)[0]
            if not torch.isfinite(loss2) or abs(float(loss2) - float(dp_loss)) \
                    >= 1e-3 * max(abs(float(dp_loss)), 1.0):
                raise AssertionError(f'dryrun_multichip::2-D mesh{name} loss {float(loss2)} '
                                     f'!= DP loss {float(dp_loss)}')
            if rank == 0:
                print(f'dryrun_multichip::2d-mesh{name} ok loss={float(loss2):.4f} '
                      f'mesh=2x{n // 2} (data x points)', flush=True)
    if rank == 0:
        print(f'dryrun_multichip::ok loss={float(loss):.4f} ranks={n} backend={backend}',
              flush=True)


def _random_mlp_state(mlp, gen):
    """Seeded weights of an `MLP` (Linear weights scaled by 1 / sqrt(fan
    in)) and non-trivial BatchNorm affines and running statistics."""
    state = {}
    for name, value in mlp.state_dict().items():
        if name.endswith('num_batches_tracked'):
            state[name] = value
        elif name.endswith('running_var') or name.endswith('2.weight'):
            state[name] = 0.5 + torch.rand(value.shape, generator=gen)
        elif value.dim() == 2:
            state[name] = torch.randn(value.shape, generator=gen) / value.shape[1] ** 0.5
        else:
            state[name] = 0.1 * torch.randn(value.shape, generator=gen)
    return state


def dryrun_multichip(n: int, device=None) -> None:
    """The three checks above on n ranks: one card each over NCCL (`device`
    None or 'cuda'; raises unless the host has n cards), or n gloo CPU
    processes (`device='cpu'`). Raises if a check fails."""
    if torch.device('cuda' if device is None else device).type == 'cpu':
        backend = 'gloo'
    else:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > cards:
            raise RuntimeError(f'dryrun_multichip: {n} ranks need {n} cards and this host '
                               f"has {cards}; pass device='cpu' to run gloo CPU processes")
        backend = 'nccl'
    spawn(_dryrun_rank, n, backend, backend=backend)


if __name__ == '__main__':
    parser = argparse.ArgumentParser(description='The port\'s multi-rank dry run.')
    parser.add_argument('n', type=int, nargs='?', default=2, help='number of ranks')
    parser.add_argument('--device', default=None,
                        help="'cpu' for gloo CPU processes; the cards by default")
    args = parser.parse_args()
    dryrun_multichip(args.n, args.device)
