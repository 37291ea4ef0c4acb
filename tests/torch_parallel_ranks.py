"""Rank functions of tests/test_torch_parallel.py,
tests/test_torch_parallel_points*.py and their configurations, and the
train CLI's tiny configuration of tests/test_torch_parallel_fit.py and the
torchrun card test.

The tests spawn gloo ranks that run these functions; this module imports
no JAX, so neither do the ranks. Each function reads its inputs from an
`.npz` the test wrote, and the first rank writes what the test compares
(with the JAX oracle the test computed) into another `.npz`.
"""
import contextlib
import json

import numpy as np
import torch
import torch.distributed as dist
import yaml

from garment_pattern_estimation_torch.models import blocks, build_model
from garment_pattern_estimation_torch.models.blocks import MLP, EdgeConv
from garment_pattern_estimation_torch.ops import edgeconv
from garment_pattern_estimation_torch.ops.knn import pairwise_sq_dists
from garment_pattern_estimation_torch.parallel import (
    make_mesh, make_mesh_2d, make_points_mesh, pad_batch_to_multiple, replicate, ring_knn_gather,
    shard_batch, sharded_encoder_step)
from garment_pattern_estimation_torch.train import Trainer

# tests/test_multichip.py's remainder-batch configuration: 5 clouds on 2 ranks
B, N, P, L = 5, 32, 5, 6
DATA = {
    'element_size': 4, 'rotation_size': 4, 'translation_size': 3,
    'max_panel_len': L, 'max_pattern_len': P, 'max_num_stitches': 4,
    'standardize': {
        'gt_shift': {'outlines': [0, 0, 0, 0], 'rotations': [0, 0, 0, 0],
                     'translations': [0, 0, 0], 'stitch_tags': [0, 0, 0]},
        'gt_scale': {'outlines': [1, 1, 1, 1], 'rotations': [1, 1, 1, 1],
                     'translations': [1, 1, 1], 'stitch_tags': [1, 1, 1]},
    },
}
NN = {'panel_encoding_size': 16, 'panel_hidden_size': 16, 'panel_n_layers': 1,
      'EConv_hidden': 8, 'EConv_feature': 8, 'conv_depth': 1, 'k_neighbors': 3,
      'local_attention': True, 'skip_connections': True, 'global_pool': 'mean',
      'lstm_init': ''}
# the same model with random LSTM states and dropout between 2 LSTM layers:
# the draws of the global batch
NN_DRAWN = dict(NN, panel_n_layers=2, lstm_init='kaiming_normal_', dropout=0.3)
LOSS = {'quality_components': []}
SETUP = {'batch_size': B, 'epochs': 2, 'learning_rate': 0.002, 'optimizer': 'Adam',
         'weight_decay': 0, 'lr_scheduling': {'mode': '1cyclic'}, 'mesh': {'data': 2}}
STEPS_PER_EPOCH = 2
# the DP cases: (NN section, the EdgeConv layers forced through the chunked sweeps)
CASES = {'zero_states': (NN, False), 'drawn': (NN_DRAWN, False), 'chunked': (NN_DRAWN, True)}
# the points-sharded cases: those two of the DP cases and a second EdgeConv
# layer at C = 24, past the exact per-dimension ranking (DIRECT_D_MAX = 16):
# the split products and the split rows of knn_gather
NN_WIDE = dict(NN, EConv_feature=24, conv_depth=2)
POINTS_CASES = ('zero_states', 'drawn', 'wide')
MODELS = dict(CASES, wide=(NN_WIDE, False))
# the points-sharded variants (tests/test_torch_parallel_points_variants*.py):
# case -> (NN section, loss section, clouds, points, the clouds' scale), of
# the attention model unless MODEL_NAMES names another.
# PointNet++ runs 4 clouds (its LSTM states aside, its BatchNorm rows are few
# per cloud), in clouds of scale 0.25, so its radius 0.3 holds neighbours;
# 76 points give M = 15 centroids, split 8 / 7 over 2 points ranks.
# pointnet_baseline is the baseline with PointNet++ and MLP decoders
# (chip_smoke.py's ENCODER_VARIANTS['pointnet']): its global max pool is
# the all-reduce max over the ranks' centroids
SEGMENTATION_LOSS = {'loss_components': ['shape', 'segmentation'], 'quality_components': [],
                     'panel_order_inariant_loss': False}
NN_POOLED = dict(NN, skip_connections=False, pool_ratio=0.5)
NN_POINTNET = dict(NN, feature_extractor='PointNetPlusPlus', skip_connections=False)
VARIANTS = {
    'max_pools': (dict(NN, local_attention=False, global_pool='max', pattern_encoding_size=16),
                  LOSS, B, N, 1.0),
    'segmentation': (NN, SEGMENTATION_LOSS, B, N, 1.0),
    'gpool': (dict(NN_POOLED, graph_pooling=True, conv_depth=2), LOSS, B, N, 1.0),
    'pool10': (dict(NN_POOLED, feature_extractor='EdgeConvPoolingFeatures'), LOSS, B, N, 1.0),
    'pointnet': (NN_POINTNET, LOSS, 4, N, 0.25),
    'pointnet_uneven': (NN_POINTNET, LOSS, 4, 76, 0.25),
    'pointnet_baseline': (dict(NN_POINTNET, pattern_encoding_size=16, pattern_hidden_size=16,
                               panel_decoder='MLPDecoder', pattern_decoder='MLPDecoder'),
                          LOSS, 4, N, 0.25),
}
MODELS.update({case: (v[0], False) for case, v in VARIANTS.items()})
LOSSES = {case: v[1] for case, v in VARIANTS.items()}
MODEL_NAMES = {'pointnet_baseline': 'GarmentFullPattern3D'}


def model_name(case):
    return MODEL_NAMES.get(base_case(case), 'GarmentSegmentPattern3D')


# these variants also run in float64 as '<case>+f64' (`float64_semantics`):
# the baseline's MLP pattern decoder normalizes the 4 clouds' near-equal
# encodings, where E[x^2] - E[x]^2 in f32 cancels to a few % of the
# variance, and its f32 gradient follows that rounding (at widths of 16 its
# one process lay 6.7% of the norm off its own f64 gradient, its sharded and
# 1e-7-noise runs under 0.1%); in f64 the sharded step is the one
# process's to rounding
F64_CASES = ('pointnet_baseline',)
F64 = '+f64'
# the variants whose stages after a graph pool's gather run the kernels'
# semantics on whole clouds: the kNN ranks the top 21 bits of each distance
# (PARITY.md #5) and the gathered rows past 16 features are the bf16 split
# hi + lo. The JAX 2-D mesh runs the XLA layer (`knn_xla`'s exact
# distances, exact f32 rows), so where they are held to it they also run as
# '<case>+xla' (`xla_semantics`)
POOL_CASES = ('gpool', 'pool10')
XLA = '+xla'


def base_case(case):
    """The case a '<case>+xla' or '<case>+f64' name runs."""
    return case.split('+')[0]


def xla_knn(x, k):
    """The choice of the JAX package's `knn_xla` in plain PyTorch: the k
    smallest of the exact norm-expansion distances (`pairwise_sq_dists`),
    ties to the lower index."""
    return torch.sort(pairwise_sq_dists(x, x), dim=-1, stable=True).indices[..., :k]


@contextlib.contextmanager
def float64_semantics(case):
    """For a case name that ends in F64, float64 throughout: the default
    dtype, and `Tensor.float()`, which the port's f32 upcasts call, gives
    float64 (the model and the batch are converted by `build` and
    `as_case_dtype`); other names run unchanged."""
    if not case.endswith(F64):
        yield
        return
    saved = torch.Tensor.float, torch.get_default_dtype()
    torch.Tensor.float = torch.Tensor.double
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.Tensor.float = saved[0]
        torch.set_default_dtype(saved[1])


def as_case_dtype(case, batch):
    """The batch with its float tensors in float64 for an F64 case name."""
    if not case.endswith(F64):
        return batch
    def cast(t):
        return t.double() if t.dtype == torch.float32 else t
    return {'features': cast(batch['features']),
            'ground_truth': {k: cast(v) for k, v in batch['ground_truth'].items()}}


@contextlib.contextmanager
def xla_semantics(case):
    """For a case name that ends in XLA, the JAX XLA layer's semantics on
    whole clouds: `blocks.knn_search` takes `xla_knn`'s choice and
    knn_gather's plain version gathers exact f32 rows
    (`ops.edgeconv.gathered_rows`); other names run unchanged."""
    saved = blocks.knn_search, edgeconv.gathered_rows
    if case.endswith(XLA):
        blocks.knn_search, edgeconv.gathered_rows = xla_knn, lambda x, value_chunks=2: x
    try:
        yield
    finally:
        blocks.knn_search, edgeconv.gathered_rows = saved
CHUNK = 12                       # 32 queries: 3 chunks, the last one padded
STEP_SEEDS = (100, 101)
EVAL_SEED = 102

# the ring cases: (B, N, C, k), as tests/test_ring.py
RING = [(2, 64, 3, 5), (1, 128, 7, 4)]


def build(case, state, device='cpu'):
    """The case's model on `device` with the given weights (in float64 for
    an F64 case name)."""
    nn_config, chunked = MODELS[base_case(case)]
    model = build_model(model_name(case), DATA, nn_config, LOSSES.get(base_case(case), LOSS),
                        device=device)
    model.module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    if case.endswith(F64):
        model.module.double()
    if chunked:
        for module in model.module.modules():
            if isinstance(module, EdgeConv):
                module.train_chunked, module.train_chunk_size = True, CHUNK
    return model


def ground_truth(rng, batch):
    """Ground truth in the dataset's shapes (tests/test_multichip.py's)."""
    return {'outlines': rng.normal(size=(batch, P, L, 4)).astype(np.float32),
            'rotations': rng.normal(size=(batch, P, 4)).astype(np.float32),
            'translations': rng.normal(size=(batch, P, 3)).astype(np.float32),
            'num_edges': np.full((batch, P), 4, dtype=np.int32),
            'num_panels': np.full((batch,), P, dtype=np.int32),
            'empty_panels_mask': np.zeros((batch, P), dtype=bool),
            'stitches': np.zeros((batch, 2, 4), dtype=np.int32),
            'num_stitches': np.ones((batch,), dtype=np.int32),
            'free_edges_mask': np.ones((batch, P, L), dtype=bool),
            'stitch_tags': rng.normal(size=(batch, P, L, 3)).astype(np.float32)}


def write_inputs(path, states):
    """The B = 5 batch (seed 3) and each case's weights (`states`: case ->
    {name: array}) into `path`; returns the arrays."""
    rng = np.random.default_rng(3)
    arrays = {'features': rng.normal(size=(B, N, 3)).astype(np.float32),
              **{f'gt.{k}': v for k, v in ground_truth(rng, B).items()}}
    for case, state in states.items():
        arrays.update({f'{case}.{k}': v for k, v in state.items()})
    np.savez(path, **arrays)
    return arrays


def write_variant_inputs(path, states, cases):
    """Each variant case's batch (seed 3 + its index in VARIANTS: its
    clouds at its scale, its GT, seeded segmentation labels; keys
    'batch.<case>.') and weights (`states`; keys '<case>.') into `path`;
    returns the arrays."""
    arrays = {}
    for case in cases:
        _, _, clouds, points, scale = VARIANTS[case]
        rng = np.random.default_rng(3 + list(VARIANTS).index(case))
        arrays[f'batch.{case}.features'] = (scale * rng.normal(size=(clouds, points, 3))).astype(
            np.float32)
        gt = dict(ground_truth(rng, clouds),
                  segmentation=rng.integers(0, P, size=(clouds, points)).astype(np.int32))
        arrays.update({f'batch.{case}.gt.{k}': v for k, v in gt.items()})
        arrays.update({f'{case}.{k}': v for k, v in states[case].items()})
    np.savez(path, **arrays)
    return arrays


def port_state(case):
    """The case's model built from seed 0, as arrays."""
    model = build_model(model_name(case), DATA, MODELS[case][0],
                        LOSSES.get(case, LOSS), device='cpu', seed=0)
    return {k: v.numpy() for k, v in model.module.state_dict().items()}


def padded_oracle(case, state, batch, world, device='cpu'):
    """The port's one-process steps on the batch padded to `world` ranks,
    the predictions cut to the real clouds before the loss, as the JAX step
    over a mesh cuts them: the two losses, the first step's gradients, then
    the eval loss. An F64 case name runs in float64."""
    with float64_semantics(case):
        return _padded_oracle(case, state, as_case_dtype(case, batch), world, device)


def _padded_oracle(case, state, batch, world, device):
    model = build(case, state, device)
    trainer = Trainer(dict(SETUP, mesh=None), device=device)
    trainer.make_optimizer(model, STEPS_PER_EPOCH)
    padded, real = pad_batch_to_multiple(batch, world)
    features = padded['features'].to(device)
    gt = {k: v.to(device) for k, v in batch['ground_truth'].items()}

    def forward(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        preds = model.module(features, generator=gen)
        return model.loss({k: v[:real] for k, v in preds.items()}, gt, epoch=0,
                          generator=gen)[0]

    losses, grads = [], None
    for seed in STEP_SEEDS:
        for group in trainer.optimizer.param_groups:
            group['lr'] = trainer.schedule(trainer.step_count)
        model.module.train()
        trainer.optimizer.zero_grad(set_to_none=True)
        loss = forward(seed)
        loss.backward()
        if grads is None:
            grads = {n: p.grad.cpu().clone() for n, p in model.module.named_parameters()
                     if p.grad is not None}
        trainer.optimizer.step()
        trainer.step_count += 1
        losses.append(float(loss.detach()))
    model.module.eval()
    with torch.no_grad():
        return losses, grads, float(forward(EVAL_SEED))


def gradient_gap(out, case, ref):
    """(|DP gradient - reference| / |reference|, the names match) over the
    whole flattened gradient."""
    names = {n[len(case) + 6:] for n in out if n.startswith(f'{case}.grad.')}
    ours = torch.cat([torch.from_numpy(out[f'{case}.grad.{n}']).reshape(-1) for n in ref])
    theirs = torch.cat([g.reshape(-1) for g in ref.values()])
    return float(torch.linalg.norm(ours - theirs) / torch.linalg.norm(theirs)), names == set(ref)


def batch_of(inputs):
    return {'features': torch.from_numpy(inputs['features']),
            'ground_truth': {k[3:]: torch.from_numpy(inputs[k]) for k in inputs
                             if k.startswith('gt.')}}


def _split(inputs, prefix):
    return {k[len(prefix):]: inputs[k] for k in inputs if k.startswith(prefix)}


def dp_rank(inputs_path, out_path, cases=tuple(CASES)):
    """An eval step, two data-parallel train steps and an eval step of each
    case on the B = 5 batch (padded to a multiple of the world) over a data
    mesh of the world: losses, the first step's gradients, whether every
    rank holds the same parameters after. On rank r's card under NCCL."""
    inputs = dict(np.load(inputs_path))
    batch = batch_of(inputs)
    world = dist.get_world_size()
    device = torch.device('cuda', dist.get_rank()) if dist.get_backend() == 'nccl' else 'cpu'
    out = {}
    for case in cases:
        model = build(case, _split(inputs, f'{case}.'), device)
        trainer = Trainer(dict(SETUP, mesh={'data': world}), device=device)
        trainer.make_optimizer(model, STEPS_PER_EPOCH)
        trainer.use_mesh(model, trainer.mesh_from_setup())
        def generator(seed):
            return torch.Generator(device=device).manual_seed(seed)
        loss, _ = trainer.eval_step(model, batch, 0, generator(EVAL_SEED))
        out[f'{case}.eval_init'] = loss.cpu().numpy()
        for i, seed in enumerate(STEP_SEEDS):
            loss, _ = trainer.train_step(model, batch, 0, generator(seed))
            out[f'{case}.loss{i}'] = loss.cpu().numpy()
            if i == 0:
                out.update({f'{case}.grad.{n}': p.grad.cpu().numpy()
                            for n, p in model.module.named_parameters() if p.grad is not None})
        loss, _ = trainer.eval_step(model, batch, 0, generator(EVAL_SEED))
        out[f'{case}.eval'] = loss.cpu().numpy()
        flat = torch.cat([p.detach().reshape(-1) for p in model.module.parameters()])
        every = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
        dist.all_gather(every, flat)
        out[f'{case}.same_params'] = np.asarray(all(torch.equal(every[0], f) for f in every))
    if dist.get_rank() == 0:
        np.savez(out_path, **out)


def points_rank(inputs_path, out_path, cases=POINTS_CASES):
    """Two train steps and an eval step of each case on the B = 5 batch (a
    variant case: its own batch, `write_variant_inputs`; `xla_semantics`
    and `float64_semantics` its name) over
    `trainer.mesh: {data: D, points: world / D}` (D from the inputs):
    losses and the first step's gradients, from the first rank."""
    inputs = dict(np.load(inputs_path))
    data = int(inputs['mesh.data'])
    mesh = {'data': data, 'points': dist.get_world_size() // data}
    out = {}
    for case in cases:
        name = base_case(case)
        batch = as_case_dtype(case, batch_of(
            _split(inputs, f'batch.{name}.') if name in VARIANTS else inputs))
        model = build(case, _split(inputs, f'{name}.'))
        trainer = Trainer(dict(SETUP, mesh=mesh), device='cpu')
        trainer.make_optimizer(model, STEPS_PER_EPOCH)
        trainer.use_mesh(model, trainer.mesh_from_setup())
        with xla_semantics(case), float64_semantics(case):
            for i, seed in enumerate(STEP_SEEDS):
                loss, _ = trainer.train_step(model, batch, 0,
                                             torch.Generator().manual_seed(seed))
                out[f'{case}.loss{i}'] = loss.numpy()
                if i == 0:
                    out.update({f'{case}.grad.{n}': p.grad.numpy().copy()
                                for n, p in model.module.named_parameters()
                                if p.grad is not None})
            loss, _ = trainer.eval_step(model, batch, 0,
                                        torch.Generator().manual_seed(EVAL_SEED))
        out[f'{case}.eval'] = loss.numpy()
        flat = torch.cat([p.detach().reshape(-1) for p in model.module.parameters()])
        every = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
        dist.all_gather(every, flat)
        out[f'{case}.same_params'] = np.asarray(all(torch.equal(every[0], f) for f in every))
    if dist.get_rank() == 0:
        np.savez(out_path, **out)


def points_refusal_rank(inputs_path, out_path, points):
    """A train step of the zero-state case over {data: 1, points: world}
    on the batch's clouds cut to `points` points: every rank's ValueError
    ('' if none), gathered after the step, so a rank that entered a
    collective would hang the test instead of passing it."""
    inputs = dict(np.load(inputs_path))
    batch = batch_of(inputs)
    batch['features'] = batch['features'][:, :points]
    model = build('zero_states', _split(inputs, 'zero_states.'))
    trainer = Trainer(dict(SETUP, mesh={'data': 1, 'points': dist.get_world_size()}),
                      device='cpu')
    trainer.make_optimizer(model, STEPS_PER_EPOCH)
    trainer.use_mesh(model, trainer.mesh_from_setup())
    try:
        trainer.train_step(model, batch, 0, torch.Generator().manual_seed(STEP_SEEDS[0]))
        error = ''
    except ValueError as err:
        error = str(err)
    errors = [None] * dist.get_world_size()
    dist.all_gather_object(errors, error)
    if dist.get_rank() == 0:
        np.savez(out_path, errors=np.asarray(errors))


def _gather_rows(t, dim):
    every = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(every, t.contiguous())
    return torch.cat(every, dim=dim)


def ring_rank(inputs_path, out_path):
    """`ring_knn_gather` over the world on each RING cloud, the mesh
    helpers, and, on 4 ranks, `sharded_encoder_step` on 4 point shards and
    on a 2 x 2 data x points mesh. Everything is gathered to the first
    rank."""
    inputs = dict(np.load(inputs_path))
    world, rank = dist.get_world_size(), dist.get_rank()
    out = {}
    for i, (_, n, _, k) in enumerate(RING):
        x = torch.from_numpy(inputs[f'ring{i}'])
        s = n // world
        nbr, idx = ring_knn_gather(x[:, rank * s:(rank + 1) * s].contiguous(), k)
        out[f'ring{i}.nbr'] = _gather_rows(nbr, 1).numpy()
        out[f'ring{i}.idx'] = _gather_rows(idx, 1).numpy()

    # the mesh helpers: padding, this rank's rows (and points), replication
    helpers = _split(inputs, 'helpers.')
    padded, real = pad_batch_to_multiple(helpers, world)
    out['pad.real'] = np.asarray(real)
    out.update({f'pad.{k}': v for k, v in padded.items()})
    mesh = make_mesh()
    rows = shard_batch(mesh, {k: torch.from_numpy(v) for k, v in padded.items()})
    out.update({f'shard.{k}': _gather_rows(v[None], 0).numpy() for k, v in rows.items()})
    module = MLP([3, 4])
    with torch.no_grad():
        for p in module.parameters():
            p.fill_(rank)
    replicate(mesh, module)
    out['replicated'] = np.asarray(all(bool((p == 0).all()) for p in module.parameters()))

    if world == 4:
        layers = []
        for j, widths in enumerate(([16, 12], [16, 8])):
            layer = EdgeConv(3 if j == 0 else 12, widths, k=4).eval()
            layer.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in _split(inputs, f'enc{j}.').items()})
            layers.append(layer.nn)
        with torch.no_grad():
            h, pooled = sharded_encoder_step(make_points_mesh(), layers,
                                             torch.from_numpy(inputs['enc.x']), 4)
        out['enc.h'] = _gather_rows(h, 1).numpy()
        out['enc.pooled'] = _gather_rows(pooled[None], 0).numpy()

        layer = EdgeConv(3, [12, 8], k=3).eval()
        layer.load_state_dict({k: torch.from_numpy(v) for k, v in _split(inputs, 'enc2d_layer.').items()})
        mesh2d = make_mesh_2d(2, 2)
        features = torch.from_numpy(inputs['enc2d.x'])
        with torch.no_grad():
            h, pooled = sharded_encoder_step(mesh2d, [layer.nn], features, 3, data_axis='data')
        out['enc2d.h'] = _gather_rows(h[None], 0).numpy()        # rank = d * 2 + p
        out['enc2d.pooled'] = _gather_rows(pooled[None], 0).numpy()
        labels = torch.arange(features.shape[0] * features.shape[1]).reshape(features.shape[:2])
        placed = shard_batch(mesh2d, {'features': features,
                                      'ground_truth': {'segmentation': labels}})
        out['shard2d.features'] = _gather_rows(placed['features'][None], 0).numpy()
        out['shard2d.segmentation'] = _gather_rows(
            placed['ground_truth']['segmentation'][None], 0).numpy()
    if rank == 0:
        np.savez(out_path, **out)


def cli_rank(rank, world, port, argv, cwd):
    """`cli.train.main(argv)` as torchrun starts it on rank `rank` of
    `world` (its environment variables; the CLI makes the process group)."""
    import os

    from garment_pattern_estimation_torch.cli import train as train_cli

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port))
    os.chdir(cwd)
    train_cli.main(argv)


# ---- the train CLI's tiny configuration (tests/test_torch_parallel_fit.py,
# the torchrun card test of tests/test_torch_cuda.py) ----

CLI_FOLDERS = ['tee_synth_300', 'skirt_synth_300', 'jumpsuit_synth_300']
CLI_CONFIG = {
    'experiment': {'project_name': 'dp-cli', 'run_name': 'att', 'run_id': None},
    'dataset': {'class': 'Garment3DPatternFullDataset', 'data_folders': CLI_FOLDERS,
                'mesh_samples': 60, 'obj_filetag': 'sim', 'point_noise_w': 0},
    'data_split': {'valid_per_type': 1, 'test_per_type': 1, 'type': 'count',
                   'random_seed': 10},
    'NN': {'model': 'GarmentSegmentPattern3D', 'conv_depth': 1, 'k_neighbors': 4,
           'EConv_hidden': 12, 'EConv_feature': 10, 'EConv_hidden_depth': 2,
           'skip_connections': True, 'local_attention': True,
           'panel_encoding_size': 16, 'panel_hidden_size': 16, 'panel_n_layers': 1,
           'lstm_init': 'zeros',
           'loss': {'loss_components': ['shape', 'loop', 'rotation', 'translation'],
                    'quality_components': ['shape', 'discrete', 'rotation', 'translation'],
                    'epoch_with_stitches': 100, 'panel_origin_invariant_loss': False,
                    'panel_order_inariant_loss': False}},
    'trainer': {'batch_size': 4, 'epochs': 1, 'random_seed': 5, 'learning_rate': 0.005,
                'optimizer': 'Adam', 'weight_decay': 0, 'lr_scheduling': {'mode': '1cyclic'},
                'with_visualization': False}}


def cli_workdir(root, workdir, mesh, dataset=None, trainer=None):
    """A working directory with system.json (datasets under `root`, runs
    under workdir/output) and att.yaml (CLI_CONFIG, `mesh` as
    trainer.mesh, `dataset` and `trainer` joining those sections); returns
    the CLI's arguments."""
    workdir.mkdir()
    (workdir / 'system.json').write_text(json.dumps({'datasets_path': str(root),
                                                     'output': str(workdir / 'output')}))
    config = json.loads(json.dumps(CLI_CONFIG))
    config['dataset'].update(dataset or {})
    config['trainer'].update(trainer or {})
    if mesh:
        config['trainer']['mesh'] = mesh
    (workdir / 'att.yaml').write_text(yaml.safe_dump(config))
    return ['-c', 'att.yaml', '--system', 'system.json']


def cli_run_files(workdir):
    """The run directory and its files, relative to the output root, run
    directory renamed."""
    out = workdir / 'output'
    (run,) = (out / 'experiments' / 'dp-cli').iterdir()
    return run, sorted(str(p.relative_to(out)).replace(run.name, 'RUN')
                       for p in out.rglob('*') if p.is_file())


def cli_losses(run):
    """(the epochs' validation losses, the steps' losses) of a run."""
    records = [json.loads(line) for line in (run / 'metrics.jsonl').read_text().splitlines()]
    return ([r['valid_loss'] for r in records if 'valid_loss' in r],
            [r['loss'] for r in records if 'batch' in r])


# ---- the points collectives (tests/test_torch_parallel_collectives.py) ----

def collective_inputs(world, seed=0):
    """The inputs of `collectives_rank` for a world of `world` ranks: a
    (2, 4 world, 3) tensor for the all-reduce max with planted ties (cloud 0,
    channel 0: two equal maxima in rank 0's points; channel 1: equal maxima
    in rank 0's and rank 1's; cloud 1, channel 2: one value everywhere),
    its cotangent, a (2, n, 5) tensor for the points gather over uneven
    shares (n = 2 world + 1) and its cotangent, (2 world + 3, 6) MLP
    rows split unevenly with the MLP's weights and the rows' cotangent, and
    (world, 1000) values for `DataShard.mean`, a row a rank."""
    rng = np.random.default_rng(seed)
    S = 4
    x = rng.normal(size=(2, S * world, 3)).astype(np.float32)
    x[0, [1, 2], 0] = 5.0                       # rank 0 holds both
    x[0, [0, S + 3], 1] = 6.0                   # rank 0 and rank 1
    x[1, :, 2] = -1.5                           # every point of every rank
    mlp = MLP([6, 8, 4])
    mlp.load_state_dict({k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
                         if v.dtype.is_floating_point and 'running' not in k else v
                         for k, v in mlp.state_dict().items()})
    return {'max.x': x, 'max.w': rng.normal(size=(2, 3)).astype(np.float32),
            'gather.x': rng.normal(size=(2, 2 * world + 1, 5)).astype(np.float32),
            'gather.w': rng.normal(size=(2, 2 * world + 1, 5)).astype(np.float32),
            'mlp.rows': rng.normal(size=(2 * world + 3, 6)).astype(np.float32),
            'mlp.w': rng.normal(size=(2 * world + 3, 4)).astype(np.float32),
            'mean.v': rng.normal(size=(world, 1000)).astype(np.float32),
            **{f'mlp.state.{k}': v.numpy() for k, v in mlp.state_dict().items()}}


def collectives_rank(inputs_path, out_path):
    """On a {data: 1, points: world} mesh, each as the trainer uses it (only
    points rank 0 backpropagates, the others backpropagate zeros): the
    all-reduce max of this rank's points and its gradient, the points
    gather over uneven shares (`PointsShard.sizes`) and its gradient,
    `DataShard.mean` of this rank's row of values over equal counts, and an
    MLP's train forward on uneven shares of rows (its BatchNorm moments
    weighed by this rank's rows, `DataShard.mean`), its running
    statistics and its parameters'
    gradients summed over the mesh. The first rank writes them, each
    rank's part in rank order."""
    from garment_pattern_estimation_torch.parallel import DataShard, sum_gradients

    inputs = dict(np.load(inputs_path))
    world = dist.get_world_size()
    shard = DataShard(make_mesh_2d(1, world))
    points = shard.points
    out = {}

    def backward(loss):
        (loss if points.rank == 0 else loss * 0.0).backward()

    x = torch.from_numpy(inputs['max.x'])
    local = points.local(x).clone().requires_grad_()
    top = points.max(local, 1)
    backward(torch.sum(top * torch.from_numpy(inputs['max.w'])))
    out['max.value'] = top.detach().numpy()
    out['max.grad'] = _gather_rows(local.grad, 1).numpy()

    whole = torch.from_numpy(inputs['gather.x'])
    sizes = points.sizes(whole.shape[1])
    start, stop = points.span(whole.shape[1])
    part = whole[:, start:stop].clone().requires_grad_()
    gathered = points.gather(part, sizes)
    backward(torch.sum(gathered * torch.from_numpy(inputs['gather.w'])))
    out['gather.value'] = gathered.detach().numpy()
    every = [None] * world
    dist.all_gather_object(every, part.grad.numpy())
    out['gather.grad'] = np.concatenate(every, axis=1)

    means = torch.from_numpy(inputs['mean.v'])
    out['mean.value'] = shard.mean(means[points.rank], rows=3).numpy()

    mlp = MLP([6, 8, 4])
    mlp.load_state_dict({k[len('mlp.state.'):]: torch.from_numpy(v) for k, v in inputs.items()
                         if k.startswith('mlp.state.')})
    mlp.data_shard = shard
    rows = torch.from_numpy(inputs['mlp.rows'])
    start, stop = points.span(rows.shape[0])
    y = mlp(rows[start:stop])
    backward(points.sum(torch.sum(y * torch.from_numpy(inputs['mlp.w'])[start:stop])))
    sum_gradients(mlp.parameters(), shard.stats_group)
    every = [None] * world
    dist.all_gather_object(every, y.detach().numpy())
    out['mlp.y'] = np.concatenate(every)
    out.update({f'mlp.grad.{n}': p.grad.numpy() for n, p in mlp.named_parameters()})
    out.update({f'mlp.buffer.{n}': b.numpy() for n, b in mlp.named_buffers()
                if 'running' in n})
    if dist.get_rank() == 0:
        np.savez(out_path, **out)
