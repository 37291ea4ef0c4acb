"""Rank functions of tests/test_torch_parallel.py and its configurations,
and the train CLI's tiny configuration of tests/test_torch_parallel_fit.py
and the torchrun card test.

The tests spawn gloo ranks that run these functions; this module imports
no JAX, so neither do the ranks. Each function reads its inputs from an
`.npz` the test wrote, and the first rank writes what the test compares
(with the JAX oracle the test computed) into another `.npz`.
"""
import json

import numpy as np
import torch
import torch.distributed as dist
import yaml

from garment_pattern_estimation_torch.models import build_model
from garment_pattern_estimation_torch.models.blocks import MLP, EdgeConv
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
CHUNK = 12                       # 32 queries: 3 chunks, the last one padded
STEP_SEEDS = (100, 101)
EVAL_SEED = 102

# the ring cases: (B, N, C, k), as tests/test_ring.py
RING = [(2, 64, 3, 5), (1, 128, 7, 4)]


def build(case, state, device='cpu'):
    """The case's model on `device` with the given weights."""
    nn_config, chunked = MODELS[case]
    model = build_model('GarmentSegmentPattern3D', DATA, nn_config, LOSS, device=device)
    model.module.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
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


def port_state(case):
    """The case's model built from seed 0, as arrays."""
    model = build_model('GarmentSegmentPattern3D', DATA, MODELS[case][0], LOSS, device='cpu',
                        seed=0)
    return {k: v.numpy() for k, v in model.module.state_dict().items()}


def padded_oracle(case, state, batch, world, device='cpu'):
    """The port's one-process steps on the batch padded to `world` ranks,
    the predictions cut to the real clouds before the loss, as the JAX step
    over a mesh cuts them: the two losses, the first step's gradients, then
    the eval loss."""
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
    """Two train steps and an eval step of each case on the B = 5 batch over
    `trainer.mesh: {data: D, points: world / D}` (D from the inputs):
    losses and the first step's gradients, from the first rank."""
    inputs = dict(np.load(inputs_path))
    batch = batch_of(inputs)
    data = int(inputs['mesh.data'])
    mesh = {'data': data, 'points': dist.get_world_size() // data}
    out = {}
    for case in cases:
        model = build(case, _split(inputs, f'{case}.'))
        trainer = Trainer(dict(SETUP, mesh=mesh), device='cpu')
        trainer.make_optimizer(model, STEPS_PER_EPOCH)
        trainer.use_mesh(model, trainer.mesh_from_setup())
        for i, seed in enumerate(STEP_SEEDS):
            loss, _ = trainer.train_step(model, batch, 0,
                                         torch.Generator().manual_seed(seed))
            out[f'{case}.loss{i}'] = loss.numpy()
            if i == 0:
                out.update({f'{case}.grad.{n}': p.grad.numpy().copy()
                            for n, p in model.module.named_parameters() if p.grad is not None})
        loss, _ = trainer.eval_step(model, batch, 0, torch.Generator().manual_seed(EVAL_SEED))
        out[f'{case}.eval'] = loss.numpy()
        flat = torch.cat([p.detach().reshape(-1) for p in model.module.parameters()])
        every = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
        dist.all_gather(every, flat)
        out[f'{case}.same_params'] = np.asarray(all(torch.equal(every[0], f) for f in every))
    if dist.get_rank() == 0:
        np.savez(out_path, **out)


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


def cli_workdir(root, workdir, mesh, dataset=None):
    """A working directory with system.json (datasets under `root`, runs
    under workdir/output) and att.yaml (CLI_CONFIG, `mesh` as
    trainer.mesh, `dataset` joining its dataset section); returns the
    CLI's arguments."""
    workdir.mkdir()
    (workdir / 'system.json').write_text(json.dumps({'datasets_path': str(root),
                                                     'output': str(workdir / 'output')}))
    config = json.loads(json.dumps(CLI_CONFIG))
    config['dataset'].update(dataset or {})
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
