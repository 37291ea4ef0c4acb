"""One-command reference-parity check (BASELINE.json north star: panel L2
and stitch F1 within 1% of the reference), on the card unless `--device
cpu` is given:

    python -m garment_pattern_estimation_torch.cli.parity_check \
        --dataset_root /data/garment_datasets \
        --shape_pth  .../neural_tailor_panels.pth \
        --stitch_pth .../neural_tailor_stitch_model.pth \
        [--expected published_metrics.json] [--jax_report parity_report.json] \
        [--torch_cross_check]

    python -m garment_pattern_estimation_torch.cli.parity_check \
        --dataset_root D --torch_train_cross_check --train_epochs 40 \
        --noise_floor --noise_seeds 3 [--port_seeds 3] [--resume] \
        [--torch_from_report R.json]

The port's counterpart of garment_pattern_estimation_tpu/cli/parity_check.py,
flag for flag, with a report of the same keys. Flags and keys that name the
JAX CLI's framework arm `jax` name the port's `port` here (`--port_seeds`,
`--stop_after_port`; `port_seed_metrics`, `_resume_port_*`,
`stopped_after_port`); every other flag and key is the JAX CLI's. Each mode
compares:
  * absolute metrics: panel L2, #panels/#edges accuracy, placement L2 of
    the `--shape_pth` checkpoint on the test split (`shape_metrics`); with
    `--stitch_pth`, stitch precision/recall/F1 and pair accuracy of that
    stitch checkpoint on the shape model's predictions (`stitch_metrics`);
  * `--expected`: those metrics against a {metric: value} JSON of
    published reference numbers (rows `published:<metric>`);
  * `--jax_report`: those metrics against the report the JAX CLI wrote on
    the same checkpoints, dataset and split (rows `jax:<metric>`): the
    port held to the JAX package without importing it;
  * `--torch_cross_check`: the port's serving forward of the `--shape_pth`
    checkpoint (`shape_metrics`, the fused layer) against the torch
    reference replica's forward of the same checkpoint
    (experiment/torch_reference.py), on the same test batches, through the
    same metric code (rows `torch:<metric>`, `torch_replica_metrics`), as
    the JAX CLI holds its own forward; and, for diagnosis, the port's f32
    forward (every EdgeConv layer on knn_gather's exact rows and an f32
    edge MLP, `_f32_metrics`) against the same replica metrics (rows
    `torch_f32:<metric>`);
  * `--torch_train_cross_check`: the port trained against the replica
    trained with the reference recipe (Adam + one-cycle + composed loss),
    from the same init (`torch.manual_seed(--train_seed)`'s replica
    weights) on the same materialized batch sequence, with best-validation
    selection on both sides; their converged test metrics (rows
    `torch_trained:<metric>`). `--noise_floor` trains `--noise_seeds` more
    replicas (seeds train_seed+1..) and widens each row's bar to the
    replica's seed-to-seed spread; `--port_seeds` trains the port from the
    same extra inits and reports the matched-init paired deltas
    (`paired_cross_framework_deltas`);
  * `--stitch_train_cross_check`: the same for the stitch pair classifier
    (rows `torch_stitch_trained:<metric>`).
Every row passes at max(`--tolerance`, its noise floor); any failed row
makes the exit code 1.

The replica is the reference recipe, not the port's oracle: its kNN ranks
with `cdist` + `topk`, and the port's kernels stay held to the JAX package's
(tests/test_torch_*.py). Both sides run on the CLI's device. The replica's
init is drawn as the JAX CLI draws it and both CLIs materialize the same
batches, so the replica columns of the two CLIs' reports agree (bitwise on
the CPU), and `--torch_from_report` reuses the replica columns of a report
written by either CLI: a user who trained the replica arms beside the JAX
package reuses them against the port. It takes the replica's halves of
`train_loss_first_step` / `train_loss_last_epoch` and keeps this run's
port halves. `--resume` reloads `--output` and skips every arm it holds;
each arm is written to `--output` as it completes.

Precision: the JAX CLI forces `jax.default_matmul_precision('highest')`
("parity runs compare against exact-f32 torch forwards"); the port's
package turns TF32 off when it is imported, so every cuBLAS matmul here,
the replica's `cdist` and MLPs included, is full f32, and this CLI keeps it
off. The fused EdgeConv layer (the serving forward, and `shape_metrics`
here) truncates its edge MLP's inputs to bf16, as the JAX package's kernel
does whatever the matmul precision; on a 30-garment test split that moves
a discrete metric by a garment, past 1% (ROADMAP.md fault C9), where the
`torch_f32:` rows stay within it. On the card `cdist` may take its matmul
form, so the replica's neighbour choices at near ties can differ from its
CPU ones: the reference's own behaviour.

Memory: on the card the replica's conv backward takes a (B, N, N, C)
buffer a step (67 GiB for conv1 of a (30, 2000) att batch); run the
training modes with PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True, or
a second replica can run out of memory on fragmented cached blocks.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from .common import load_yaml
from ..data import DATASET_REGISTRY, DatasetWrapper, GarmentStitchPairsDataset
from ..device import resolve_device
from ..experiment.torch_import import load_checkpoint_any
from ..experiment.torch_reference import (
    TorchGarmentFullPattern3D, TorchGarmentSegmentPattern3D, TorchStitchOnEdge3DPairs,
    train_reference_stitch_torch, train_reference_torch)
from ..models import build_model
from ..models.blocks import unfused_eval
from ..train import Trainer, cosine_onecycle_schedule, eval_metrics, make_predict_fn

SHAPE_METRICS = ('panel_shape_l2', 'num_panels_accuracy', 'num_edges_accuracy',
                 'rotation_l2', 'translation_l2')
STITCH_METRICS = ('stitch_precision', 'stitch_recall', 'stitch_f1',
                  'edge_pair_class_acc')


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--dataset_root', required=True)
    parser.add_argument('--shape_config', default='./configs/att.yaml')
    parser.add_argument('--shape_pth', default='',
                        help='reference shape checkpoint (.pth) or a port checkpoint; '
                             'optional with --torch_train_cross_check / '
                             '--stitch_train_cross_check')
    parser.add_argument('--stitch_config', default='./configs/stitch_model.yaml')
    parser.add_argument('--stitch_pth', default='',
                        help='reference stitch checkpoint; omit to skip stage 2')
    parser.add_argument('--expected', default='',
                        help='JSON of published metric values to compare against')
    parser.add_argument('--jax_report', default='',
                        help="the JAX CLI's report on the same checkpoints, dataset and "
                             'split: its shape and stitch metrics become jax:<metric> rows')
    parser.add_argument('--tolerance', type=float, default=0.01)
    parser.add_argument('--torch_cross_check', action='store_true',
                        help='replay --shape_pth through the torch reference replica on '
                             'the same test batches: torch:<metric> rows')
    parser.add_argument('--torch_train_cross_check', action='store_true',
                        help='TRAIN the torch reference recipe and the port from the same '
                             'init on the same batches and compare converged test metrics')
    parser.add_argument('--stitch_train_cross_check', action='store_true',
                        help='TRAIN the torch stitch pair classifier (reference recipe) '
                             'and the port stitch model from the same init on the same '
                             'pair batches; compare converged stitch P/R/F1 + pair accuracy')
    parser.add_argument('--train_epochs', type=int, default=40,
                        help='epochs for --torch_train_cross_check / '
                             '--stitch_train_cross_check')
    parser.add_argument('--train_seed', type=int, default=0)
    parser.add_argument('--noise_floor', action='store_true',
                        help='train extra replica seeds (train_seed+1..+noise_seeds, same '
                             'batches) and widen each row to the replica-vs-replica spread')
    parser.add_argument('--noise_seeds', type=int, default=1,
                        help='number of EXTRA replica seeds for --noise_floor')
    parser.add_argument('--port_seeds', type=int, default=0,
                        help='with --torch_train_cross_check: also train N extra port '
                             'stacks from the torch.manual_seed(train_seed+1..+N) inits the '
                             '--noise_floor replicas use, and report matched-init paired '
                             'cross-framework deltas')
    parser.add_argument('--resume', action='store_true',
                        help='if --output exists, reload it and skip every training arm it '
                             'holds (each completed arm is written to --output at once); '
                             'valid only for the SAME config/dataset/split/seed arguments')
    parser.add_argument('--stop_after_port', action='store_true',
                        help='with --torch_train_cross_check: exit after the port arms '
                             '(base + --port_seeds) are trained and written; rerun with '
                             '--resume to add the replica arms')
    parser.add_argument('--torch_from_report', default='',
                        help='reuse the replica columns (trained metrics + noise-seed '
                             'metrics) of a previous --torch_train_cross_check report of '
                             'either CLI; valid only for the SAME config/dataset/split')
    parser.add_argument('--max_datapoints', type=int, default=None,
                        help='cap per-type datapoints (quick smoke runs)')
    parser.add_argument('--output', default='./parity_report.json')
    parser.add_argument('--device', default=None,
                        help="torch device (default: 'cuda'; 'cpu' runs the plain "
                             'PyTorch path)')
    return parser.parse_args(argv)


def _build_shape_stack(args, device, load_checkpoint=True):
    config = load_yaml(args.shape_config)
    data_config = dict(config['dataset'])
    if args.max_datapoints:
        data_config['max_datapoints_per_type'] = args.max_datapoints
    dataset = DATASET_REGISTRY[data_config.get('class', 'Garment3DPatternFullDataset')](
        Path(args.dataset_root), data_config, gt_caching=True, feature_caching=True)
    wrapper = DatasetWrapper(dataset)
    wrapper.load_split(config.get('data_split', {}))
    wrapper.new_loaders(config['trainer']['batch_size'])
    wrapper.standardize_data()

    # zero LSTM init states on every side of a comparison: the reference's
    # random-state noise (batch-shape-dependent) would otherwise blur the
    # 1% check
    nn_config = dict(config['NN'], lstm_init='')
    model = build_model(nn_config.get('model', 'GarmentSegmentPattern3D'), dataset.config,
                        nn_config, nn_config.get('loss', {}), device=device)
    state = _module_state(model, load_checkpoint_any(args.shape_pth)['model']) \
        if load_checkpoint else None
    return config, dataset, wrapper, model, state


def _module_state(model, state):
    """The checkpoint's entries the module has: a reference attention
    model's file also carries its encoder's unused global-pool `lin`, which
    the JAX importer (experiment/torch_import.py) maps to nothing either. A
    missing entry still fails the strict load."""
    names = set(model.module.state_dict())
    unused = sorted(k for k in state if k not in names)
    if unused:
        print(f'parity_check::checkpoint entries the model does not use: {unused}')
    return {k: v for k, v in state.items() if k in names}


def _replica_from_config(config, dataset):
    nn_cfg = config['NN']
    if nn_cfg.get('model', 'GarmentSegmentPattern3D') == 'GarmentFullPattern3D':
        return TorchGarmentFullPattern3D(
            max_pattern_len=dataset.config['max_pattern_len'],
            max_panel_len=dataset.config['max_panel_len'],
            element_size=dataset.config['element_size'],
            panel_encoding_size=nn_cfg.get('panel_encoding_size', 250),
            panel_hidden_size=nn_cfg.get('panel_hidden_size', 250),
            panel_n_layers=nn_cfg.get('panel_n_layers', 3),
            pattern_encoding_size=nn_cfg.get('pattern_encoding_size', 250),
            pattern_hidden_size=nn_cfg.get('pattern_hidden_size', 250),
            pattern_n_layers=nn_cfg.get('pattern_n_layers', 2),
            econv_hidden=nn_cfg.get('EConv_hidden', 200),
            econv_hidden_depth=nn_cfg.get('EConv_hidden_depth', 2),
            econv_feature=nn_cfg.get('EConv_feature', 150),
            k_neighbors=nn_cfg.get('k_neighbors', 5),
            conv_depth=nn_cfg.get('conv_depth', 2),
            skip_connections=nn_cfg.get('skip_connections', True))
    return TorchGarmentSegmentPattern3D(
        max_pattern_len=dataset.config['max_pattern_len'],
        max_panel_len=dataset.config['max_panel_len'],
        element_size=dataset.config['element_size'],
        panel_encoding_size=nn_cfg.get('panel_encoding_size', 250),
        panel_hidden_size=nn_cfg.get('panel_hidden_size', 250),
        panel_n_layers=nn_cfg.get('panel_n_layers', 3),
        econv_hidden=nn_cfg.get('EConv_hidden', 200),
        econv_hidden_depth=nn_cfg.get('EConv_hidden_depth', 2),
        econv_feature=nn_cfg.get('EConv_feature', 150),
        k_neighbors=nn_cfg.get('k_neighbors', 5),
        conv_depth=nn_cfg.get('conv_depth', 2),
        skip_connections=nn_cfg.get('skip_connections', True))


def _seeded(seed, build, device):
    """build() under `torch.manual_seed(seed)`, moved to `device`. The JAX
    CLI draws its replica inits from the global generator so; drawing them
    alike gives the port the same init bit for bit, which is what lets one
    CLI reuse the other's replica columns. It is the one use of the global
    generator in the port, so its state is restored after."""
    with torch.random.fork_rng(devices=list(range(torch.cuda.device_count()))):
        torch.manual_seed(seed)
        return build().to(device)


def _init_state(model, replica):
    """The replica's weights as the port model's state dict: the same
    names, less the entries only the replica has."""
    return {k: v.detach().clone() for k, v in _module_state(model, replica.state_dict()).items()}


def _load_replica(replica, state):
    """`state` into the replica, strictly apart from the entries its forward
    never reads (`unread_state`: the attention model's global-pool head,
    which a port checkpoint lacks); their names are printed. A silent
    non-strict load would leave random weights that look like parity."""
    current = replica.state_dict()
    unread = sorted(k for k in replica.unread_state if k not in state)
    if unread:
        print(f'parity_check::replica entries the checkpoint lacks, which its forward '
              f'never reads: {unread}')
    replica.load_state_dict({**{k: current[k] for k in unread}, **state}, strict=True)
    return replica


def _accumulate(metrics, loss_dict):
    for key, value in loss_dict.items():
        if isinstance(value, torch.Tensor) and value.dim() == 0:
            value = float(value)
            if np.isfinite(value):
                metrics.setdefault(key, []).append(value)


@torch.no_grad()
def _torch_eval_metrics(replica, wrapper, model, section='test'):
    """Evaluate a replica on `section` batches through the port's loss and
    metric stack (`ComposedPatternLoss`), on the replica's device — the
    same aggregation as train/eval_utils.eval_metrics (unweighted batch
    mean, non-finite metrics skipped)."""
    replica.eval()
    model.loss.with_quality_eval = True
    device = next(replica.parameters()).device
    metrics = {}
    for batch in wrapper.get_loader(section):
        preds = replica(torch.as_tensor(np.asarray(batch['features'], np.float32)).to(device))
        gt = {k: torch.as_tensor(np.asarray(v)).to(device)
              for k, v in batch['ground_truth'].items()}
        _accumulate(metrics, model.loss(preds, gt)[1])
    return {k: sum(v) / len(v) for k, v in metrics.items() if v}


@torch.no_grad()
def _torch_eval_stitch_metrics(replica, wrapper, model, section='test'):
    """The replica pair classifier on `section` batches through the port's
    `ComposedLoss` metric stack, on the replica's device."""
    replica.eval()
    model.loss.with_quality_eval = True
    device = next(replica.parameters()).device
    metrics = {}
    for batch in wrapper.get_loader(section):
        logits = replica(torch.as_tensor(np.asarray(batch['features'], np.float32)).to(device))
        labels = torch.as_tensor(np.asarray(batch['ground_truth'])).to(device)
        _accumulate(metrics, model.loss(logits, labels)[1])
    return _with_f1({k: sum(v) / len(v) for k, v in metrics.items() if v})


def _with_f1(metrics):
    p, r = metrics.get('stitch_precision'), metrics.get('stitch_recall')
    if p is not None and r is not None:
        metrics['stitch_f1'] = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    return metrics


def _scalars(metrics):
    return {k: float(v) for k, v in metrics.items()
            if v is not None and np.ndim(v) == 0 and np.isfinite(float(v))}


def _host_batch(batch):
    """A loader batch as host float32 features and numpy ground truth (a
    dict for the shape models, the (B, P) labels for the stitch model)."""
    gt = batch['ground_truth']
    return {'features': np.asarray(batch['features'], np.float32),
            'ground_truth': ({k: np.asarray(v) for k, v in gt.items()} if isinstance(gt, dict)
                             else np.asarray(gt, np.float32))}


def _tensor_batch(batch):
    gt = batch['ground_truth']
    return {'features': torch.from_numpy(batch['features']),
            'ground_truth': ({k: torch.from_numpy(v) for k, v in gt.items()}
                             if isinstance(gt, dict) else torch.from_numpy(gt))}


def _train_port(model, init, epoch_batches, valid_batches, schedule, device,
                epoch_with_stitches=None):
    """Train the port's model from the state dict `init` with Adam and
    `schedule`'s per-step lr (`Trainer.train_step`: zero LSTM states, the
    loss at the epoch's phase) on the materialized batches; after every
    epoch the mean validation loss (`Trainer.eval_step`), and the
    best-validation weights restored at the end, as the replica's recipe
    does (the best resets when the stitch terms join). Returns the per-step
    loss history."""
    model.module.load_state_dict(init)
    trainer = Trainer({'learning_rate': schedule(0), 'optimizer': 'Adam'}, device=device)
    trainer.make_optimizer(model, len(epoch_batches[0]))
    trainer.schedule = schedule
    history = []
    best = (float('inf'), None)
    for epoch, batches in enumerate(epoch_batches):
        if epoch == epoch_with_stitches:
            best = (float('inf'), None)  # loss structure changed: reset
        losses = [trainer.train_step(model, _tensor_batch(b), epoch)[0] for b in batches]
        history += torch.stack(losses).tolist()
        val = float(np.mean([float(trainer.eval_step(model, _tensor_batch(b), epoch)[0])
                             for b in valid_batches]))
        if val < best[0]:
            best = (val, {k: v.clone() for k, v in model.module.state_dict().items()})
    if best[1] is not None:
        model.module.load_state_dict(best[1])
    return history


def _train_cross_check(args, config, dataset, wrapper, model, report, device):
    """Train the torch replica (reference recipe: Adam + OneCycle + composed
    loss, nn/trainer.py:162-185) AND the port from the same init on the
    same batch sequence; compare converged test metrics.

    Both stacks: zero recurrent init states, one schedule
    (`cosine_onecycle_schedule`) driving the per-step lr, identical
    standardized host batches, the CLI's device."""
    # --resume: reload a previous (partial) report and skip completed arms.
    # Training arms stash their full metric dicts under `_resume_*` keys and
    # the report is written to --output after EVERY arm, so a killed
    # campaign loses at most the arm in flight.
    if args.resume and Path(args.output).exists():
        prior_state = json.loads(Path(args.output).read_text())
        report.update(prior_state)
        done = [k for k in ('_resume_port_base_metrics', '_resume_torch_base_metrics')
                if k in prior_state]
        done += [f'{k}[{len(prior_state[k])}]'
                 for k in ('_resume_port_seed_metrics', '_resume_torch_noise_metrics')
                 if prior_state.get(k)]
        print(f'parity_check::resuming from {args.output}; completed arms: '
              f'{done or "none"}', flush=True)

    def flush():
        Path(args.output).write_text(json.dumps(report, indent=1))

    loss_cfg = model.loss.config
    unsupported = [c for c in loss_cfg['loss_components']
                   if c not in ('shape', 'loop', 'rotation', 'translation', 'stitch',
                                'free_class')]
    if unsupported or loss_cfg.get('panel_order_inariant_loss') \
            or loss_cfg.get('panel_origin_invariant_loss'):
        raise NotImplementedError(
            'parity_check::--torch_train_cross_check replicates the reference recipes '
            'without order/origin GT matching (components among shape/loop/rotation/'
            f'translation/stitch/free_class); config asks for {loss_cfg["loss_components"]}')
    has_stitch_terms = any(c in loss_cfg['loss_components'] for c in ('stitch', 'free_class'))
    # the mid-training loss-structure change (stitch terms join at this
    # epoch — reference nn/metrics/composed_loss.py:259-265)
    epoch_with_stitches = loss_cfg.get('epoch_with_stitches', 40) if has_stitch_terms else None

    # one materialized batch sequence consumed by BOTH stacks
    epoch_batches = [[_host_batch(b) for b in wrapper.loaders.train]
                     for _ in range(args.train_epochs)]
    total_steps = sum(len(e) for e in epoch_batches)
    lr = config['trainer'].get('learning_rate', 2e-3)
    schedule = cosine_onecycle_schedule(max(total_steps, 4), lr)
    # best-validation model selection for BOTH stacks — the reference
    # recipe's 'best' checkpoint (nn/trainer.py:214-219)
    valid_batches = [_host_batch(b) for b in wrapper.loaders.validation]

    def replica_of(seed):
        return _seeded(seed, lambda: _replica_from_config(config, dataset), device)

    replica = replica_of(args.train_seed)
    pad_vector = np.asarray(model.loss.pad_vector, np.float32)
    loop_w = loss_cfg.get('loop_loss_weight', 1.0)

    def progress(step, loss):
        if step % 60 == 0:
            print(f'parity_check::torch step {step}/{total_steps} loss={loss:.5f}', flush=True)

    def train_replica(replica_n):
        return train_reference_torch(
            replica_n, epoch_batches, schedule, pad_vector, loop_weight=loop_w,
            on_step=progress, valid_batches=valid_batches,
            epoch_with_stitches=epoch_with_stitches,
            stitch_margin=loss_cfg.get('stitch_tags_margin', 0.3),
            use_hardnet=loss_cfg.get('stitch_hardnet_version', False))

    def train_port(replica_n):
        return _train_port(model, _init_state(model, replica_n), epoch_batches, valid_batches,
                           schedule, device, epoch_with_stitches)

    if '_resume_port_base_metrics' in report:
        print('parity_check::the port base arm reloaded from the resume report')
        ours = dict(report['_resume_port_base_metrics'])
    else:
        print('parity_check::training the port on the materialized batches')
        port_hist = train_port(replica)
        print('parity_check::evaluating the trained port on the test split')
        ours = eval_metrics(model, None, wrapper, 'test')
        report['_resume_port_base_metrics'] = _scalars(ours)
        report['_port_loss_first_step'] = float(port_hist[0])
        report['_port_loss_last_epoch_mean'] = float(
            np.mean(port_hist[-len(epoch_batches[-1]):]))
        flush()

    # extra port seeds (the paired-delta instrument): for init seed s, the
    # replica and the port both start from the torch.manual_seed(s)
    # weights, so (port_s, torch_s) are matched pairs
    port_seed_metrics = [dict(m) for m in report.get('_resume_port_seed_metrics', [])]
    for extra in range(len(port_seed_metrics) + 1, (args.port_seeds or 0) + 1):
        seed = args.train_seed + extra
        print(f'parity_check::training port seed {seed} ({extra}/{args.port_seeds})')
        train_port(replica_of(seed))
        port_seed_metrics.append(eval_metrics(model, None, wrapper, 'test'))
        report['_resume_port_seed_metrics'] = [_scalars(m) for m in port_seed_metrics]
        flush()

    if args.stop_after_port:
        print('parity_check::--stop_after_port — port arms complete '
              f'({1 + len(port_seed_metrics)} trained); rerun with --resume to add the '
              'replica arms')
        report['stopped_after_port'] = True
        flush()
        return ours, []
    report.pop('stopped_after_port', None)

    prior = json.loads(Path(args.torch_from_report).read_text()) \
        if args.torch_from_report else None
    if '_resume_torch_base_metrics' in report:
        print('parity_check::torch base arm reloaded from the resume report')
        torch_metrics = dict(report['_resume_torch_base_metrics'])
    elif prior is not None:
        # the replica columns of a previous report, of either CLI (the same
        # config, dataset, split and so batches: the loaders are
        # seed-pinned); the port halves of the losses stay this run's
        print(f'parity_check::torch columns from {args.torch_from_report}')
        torch_metrics = dict(prior['torch_trained_metrics'])
        for key, ours_key in (('train_loss_first_step', '_port_loss_first_step'),
                              ('train_loss_last_epoch', '_port_loss_last_epoch_mean')):
            report[key] = {'torch': (prior.get(key) or {}).get('torch'),
                           'ours': report[ours_key]}
        report['torch_columns_reused_from'] = str(args.torch_from_report)
    else:
        print(f'parity_check::training the torch reference recipe '
              f'({args.train_epochs} epochs x {len(epoch_batches[0])} batches)')
        torch_hist = train_replica(replica)
        report['train_loss_first_step'] = {'torch': torch_hist[0],
                                           'ours': report['_port_loss_first_step']}
        report['train_loss_last_epoch'] = {
            'torch': float(np.mean(torch_hist[-len(epoch_batches[-1]):])),
            'ours': report['_port_loss_last_epoch_mean']}
        print(f"parity_check::first-step loss torch={torch_hist[0]:.5f} "
              f"ours={report['_port_loss_first_step']:.5f}; last-epoch mean "
              f"torch={report['train_loss_last_epoch']['torch']:.5f} "
              f"ours={report['train_loss_last_epoch']['ours']:.5f}")
        print('parity_check::evaluating the torch model on the test split (same metric stack)')
        torch_metrics = _torch_eval_metrics(replica, wrapper, model)
        report['_resume_torch_base_metrics'] = _scalars(torch_metrics)
        flush()
    metric_keys = SHAPE_METRICS + (
        ('stitch_precision', 'stitch_recall', 'free_edge_acc') if has_stitch_terms else ())
    if port_seed_metrics:
        report['port_seed_metrics'] = [{k: m.get(k) for k in metric_keys if k in m}
                                       for m in port_seed_metrics]
    report['trained_shape_metrics'] = {k: ours.get(k) for k in metric_keys if k in ours}
    report['torch_trained_metrics'] = {k: torch_metrics.get(k) for k in metric_keys
                                       if k in torch_metrics}

    seed_metrics = list(prior.get('torch_noise_seed_metrics', [])) if prior else []
    if not seed_metrics:
        seed_metrics = [dict(m) for m in report.get('_resume_torch_noise_metrics', [])]
    if args.noise_floor:
        # extra replica runs: same batches/schedule, init seeds +1..+N — the
        # metric spread among replica seeds is the noise the converged-metric
        # comparison inherits. One seed gives a single pairwise delta
        # (underestimates the envelope); prefer 3+.
        for extra in range(len(seed_metrics) + 1, max(args.noise_seeds, 1) + 1):
            seed = args.train_seed + extra
            print(f'parity_check::noise floor — training torch seed {seed} '
                  f'({extra}/{args.noise_seeds})')
            replica_n = replica_of(seed)
            train_replica(replica_n)
            metrics_n = _torch_eval_metrics(replica_n, wrapper, model)
            seed_metrics.append(metrics_n)
            report['_resume_torch_noise_metrics'] = [_scalars(m) for m in seed_metrics]
            flush()
            print('parity_check::seed %d metrics: %s' % (seed, {
                k: round(metrics_n[k], 5) for k in metric_keys if k in metrics_n}), flush=True)
    floors = None
    if seed_metrics:
        report['torch_noise_seed_metrics'] = [{k: m.get(k) for k in metric_keys if k in m}
                                              for m in seed_metrics]
        floors = _noise_floors(torch_metrics, seed_metrics, metric_keys)
        report['torch_noise_floor'] = floors

    if port_seed_metrics:
        # matched-init paired deltas: pair i uses torch.manual_seed(i)
        # weights on BOTH sides. The mean paired delta is the cleanest
        # systematic-offset estimate — per-seed chaos cancels in the mean,
        # a real cross-framework bias does not
        paired = {}
        for key in metric_keys:
            deltas = [(p[key] - t[key]) / max(abs(t[key]), 1e-3)
                      for t, p in zip([torch_metrics] + seed_metrics, [ours] + port_seed_metrics)
                      if t.get(key) is not None and p.get(key) is not None]
            if deltas:
                paired[key] = {'per_seed_signed': deltas,
                               'mean_abs': float(np.mean(np.abs(deltas))),
                               'mean_signed': float(np.mean(deltas)),
                               'max_abs': float(np.max(np.abs(deltas)))}
        report['paired_cross_framework_deltas'] = paired
        print('parity_check::paired cross-framework deltas (mean signed): '
              + json.dumps({k: round(v['mean_signed'], 4) for k, v in paired.items()}))
    return ours, _compare_rows(ours, torch_metrics, metric_keys, 'torch_trained',
                               floors=floors)


def _noise_floors(base, seed_metrics, keys):
    """Per metric, the largest relative spread of a seed's value from the
    base replica's (denominator floored at 1e-3)."""
    floors = {}
    for key in keys:
        vals = [m.get(key) for m in seed_metrics if m.get(key) is not None]
        if base.get(key) is not None and vals:
            floors[key] = max(abs(v - base[key]) / max(abs(base[key]), 1e-3) for v in vals)
    return floors


def _stitch_train_cross_check(args, report, device):
    """Stage-2 trained A/B: the torch stitch pair classifier (reference
    recipe — BCE on pair logits, Adam + OneCycle, nn/trainer.py:162-185 +
    nn/metrics/composed_loss.py:11-126) vs the port's stitch model, from the
    same init, on the same materialized pair batches; converged stitch
    P/R/F1 + pair accuracy compared on the same test pairs through the same
    metric code."""
    cfg = load_yaml(args.stitch_config)
    data_cfg = dict(cfg['dataset'])
    # freeze the sampled pair sets: both stacks (and every eval) must see
    # the identical pairs
    data_cfg.setdefault('pairs_seed', 17)
    if args.max_datapoints:
        data_cfg['max_datapoints_per_type'] = args.max_datapoints
    dataset = GarmentStitchPairsDataset(Path(args.dataset_root), data_cfg, gt_caching=True,
                                        feature_caching=True)
    wrapper = DatasetWrapper(dataset)
    wrapper.load_split(cfg.get('data_split', {}))
    wrapper.new_loaders(cfg['trainer']['batch_size'])
    wrapper.standardize_data()
    model = build_model('StitchOnEdge3DPairs', dataset.config, cfg['NN'],
                        cfg['NN'].get('loss', {}), device=device)

    def replica_of(seed):
        return _seeded(seed, lambda: TorchStitchOnEdge3DPairs(
            pair_feature_len=dataset.config['element_size'],
            hidden=cfg['NN'].get('stitch_hidden_size', 200),
            n_layers=cfg['NN'].get('stitch_mlp_n_layers', 3)), device)

    replica = replica_of(args.train_seed)
    # one materialized batch sequence consumed by BOTH stacks
    epoch_batches = [[_host_batch(b) for b in wrapper.loaders.train]
                     for _ in range(args.train_epochs)]
    valid_batches = [_host_batch(b) for b in wrapper.loaders.validation]
    total_steps = sum(len(e) for e in epoch_batches)
    schedule = cosine_onecycle_schedule(max(total_steps, 4),
                                        cfg['trainer'].get('learning_rate', 2e-3))

    print('parity_check::stitch A/B — training the port')
    port_hist = _train_port(model, _init_state(model, replica), epoch_batches, valid_batches,
                            schedule, device)
    ours = _with_f1(eval_metrics(model, None, wrapper, 'test'))

    def progress(step_i, loss):
        if step_i % 100 == 0:
            print(f'parity_check::torch stitch step {step_i}/{total_steps} loss={loss:.5f}',
                  flush=True)

    print(f'parity_check::stitch A/B — training the torch reference recipe '
          f'({args.train_epochs} epochs x {len(epoch_batches[0])} batches)')
    torch_hist = train_reference_stitch_torch(replica, epoch_batches, schedule,
                                              on_step=progress, valid_batches=valid_batches)
    report['stitch_train_loss_first_step'] = {'torch': torch_hist[0], 'ours': port_hist[0]}
    torch_metrics = _torch_eval_stitch_metrics(replica, wrapper, model)
    report['stitch_trained_metrics'] = {k: ours.get(k) for k in STITCH_METRICS if k in ours}
    report['torch_stitch_trained_metrics'] = {k: torch_metrics.get(k) for k in STITCH_METRICS
                                              if k in torch_metrics}

    floors = None
    if args.noise_floor:
        seed_metrics = []
        for extra in range(1, max(args.noise_seeds, 1) + 1):
            seed = args.train_seed + extra
            print(f'parity_check::stitch noise floor — torch seed {seed} '
                  f'({extra}/{args.noise_seeds})')
            replica_n = replica_of(seed)
            train_reference_stitch_torch(replica_n, epoch_batches, schedule, on_step=progress,
                                         valid_batches=valid_batches)
            metrics_n = _torch_eval_stitch_metrics(replica_n, wrapper, model)
            seed_metrics.append(metrics_n)
            print('parity_check::stitch seed %d metrics: %s' % (seed, {
                k: round(metrics_n[k], 5) for k in STITCH_METRICS if k in metrics_n}),
                flush=True)
        report['torch_stitch_noise_seed_metrics'] = [
            {k: m.get(k) for k in STITCH_METRICS if k in m} for m in seed_metrics]
        floors = _noise_floors(torch_metrics, seed_metrics, STITCH_METRICS)
        report['torch_stitch_noise_floor'] = floors
    return ours, _compare_rows(ours, torch_metrics, STITCH_METRICS, 'torch_stitch_trained',
                               floors=floors)


def _torch_replica_metrics(config, dataset, wrapper, model, shape_pth, device):
    """Replay the checkpoint with the torch replica on the SAME test batches
    and compute the SAME metrics via the port's loss stack — model-level
    parity."""
    replica = _replica_from_config(config, dataset).to(device)
    _load_replica(replica, load_checkpoint_any(shape_pth)['model'])
    return _torch_eval_metrics(replica, wrapper, model)


def _f32_metrics(model, state, wrapper, section='test'):
    """`eval_metrics` of the port's f32 forward: every EdgeConv layer off
    the fused layer (`blocks.unfused_eval`), on knn_gather's exact rows and
    the f32 edge MLP. The fused layer, the serving forward, truncates its
    edge MLP's inputs to bf16 as the JAX kernel does."""
    with unfused_eval():
        return eval_metrics(model, state, wrapper, section)


def _compare_rows(ours, other, keys, label, floors=None):
    """Rows of (name, ours, reference, delta, extra_tolerance) for the keys
    both sides have; delta relative to the reference, floored at 1e-3
    (accuracies near 0). A row passes at max(--tolerance,
    extra_tolerance): the --noise_floor modes widen it to the replica's
    seed-to-seed spread."""
    rows = []
    for key in keys:
        a, b = ours.get(key), other.get(key)
        if a is None or b is None:
            continue
        extra = floors.get(key, 0.0) if floors else 0.0
        rows.append((f'{label}:{key}', a, b, abs(a - b) / max(abs(b), 1e-3), extra))
    return rows


def _stitch_metrics(args, model, state, wrapper, device):
    """Stage 2: the shape model's test predictions saved, the stitch model
    from `--stitch_pth` evaluated on their exhaustive edge pairs."""
    predict_fn = make_predict_fn(model, state)
    pred_path = wrapper.predict(predict_fn, Path('./parity_predictions'), dir_tag='parity',
                                sections=['test'], orig_folder_names=True)
    stitch_cfg = load_yaml(args.stitch_config)
    pred_test = Path(pred_path) / 'test'
    stitch_data_cfg = dict(stitch_cfg['dataset'], random_pairs_mode=False,
                           data_folders=sorted(d.name for d in pred_test.iterdir()
                                               if d.is_dir()))
    if 'standardize' not in stitch_data_cfg:
        # the checkpoint was trained on inputs standardized with ITS
        # training-set stats; recomputing them from today's predictions
        # shifts every first-layer activation
        print('parity_check::WARNING::no `standardize` block in the stitch config — '
              'feature stats will be recomputed from the current predictions. For a '
              'faithful parity number, copy the f_shift/f_scale from the reference run '
              f'config into {args.stitch_config} (dataset.standardize).')
    stitch_dataset = GarmentStitchPairsDataset(pred_test, stitch_data_cfg, gt_caching=True,
                                               feature_caching=True)
    stitch_wrapper = DatasetWrapper(stitch_dataset, batch_size=1)
    stitch_wrapper.standardize_data()
    stitch_model = build_model('StitchOnEdge3DPairs', stitch_dataset.config, stitch_cfg['NN'],
                               stitch_cfg['NN'].get('loss', {}), device=device)
    stitch_state = _module_state(stitch_model, load_checkpoint_any(args.stitch_pth)['model'])
    metrics = _with_f1(eval_metrics(stitch_model, stitch_state, stitch_wrapper, 'full'))
    return {k: metrics.get(k) for k in STITCH_METRICS if k in metrics}


def main(argv=None):
    args = get_args(argv)
    device = resolve_device(args.device)
    report = {'dataset_root': args.dataset_root, 'shape_pth': args.shape_pth}
    if not args.shape_pth and not args.torch_train_cross_check \
            and not args.stitch_train_cross_check:
        raise SystemExit('parity_check::--shape_pth is required unless '
                         '--torch_train_cross_check / --stitch_train_cross_check train '
                         'from scratch')
    if device.type == 'cuda' and (args.torch_train_cross_check
                                  or args.stitch_train_cross_check) \
            and 'expandable_segments:True' not in os.environ.get('PYTORCH_CUDA_ALLOC_CONF', ''):
        print('parity_check::WARNING::PYTORCH_CUDA_ALLOC_CONF lacks '
              'expandable_segments:True: a second replica can run out of memory on '
              'fragmented cached blocks (see the module docstring)')
    if args.stitch_pth and not args.shape_pth:
        raise SystemExit('parity_check::--stitch_pth evaluates on the predictions of '
                         '--shape_pth, which is missing')

    rows = []
    ours = {}
    state = None
    if args.shape_pth or args.torch_train_cross_check:
        config, dataset, wrapper, model, state = _build_shape_stack(
            args, device, load_checkpoint=bool(args.shape_pth))

    if args.torch_train_cross_check:
        ours, train_rows = _train_cross_check(args, config, dataset, wrapper, model, report,
                                              device)
        rows += train_rows

    if args.stitch_train_cross_check:
        stitch_ours, stitch_rows = _stitch_train_cross_check(args, report, device)
        ours.update(stitch_ours)
        rows += stitch_rows

    if state is not None:
        print('parity_check::evaluating shape model on the test split')
        ours = eval_metrics(model, state, wrapper, 'test')
        report['shape_metrics'] = {k: ours.get(k) for k in SHAPE_METRICS if k in ours}
        print(json.dumps(report['shape_metrics'], indent=1))

    if args.torch_cross_check and args.shape_pth:
        print('parity_check::torch replica cross-check (same batches, same metrics)')
        torch_metrics = _torch_replica_metrics(config, dataset, wrapper, model,
                                               args.shape_pth, device)
        report['torch_replica_metrics'] = {k: torch_metrics.get(k) for k in SHAPE_METRICS
                                           if k in torch_metrics}
        rows += _compare_rows(ours, torch_metrics, SHAPE_METRICS, 'torch')
        rows += _compare_rows(_f32_metrics(model, state, wrapper), torch_metrics,
                              SHAPE_METRICS, 'torch_f32')

    if args.stitch_pth:
        print('parity_check::stage 2 — stitches on shape predictions')
        report['stitch_metrics'] = _stitch_metrics(args, model, state, wrapper, device)
        ours.update(report['stitch_metrics'])
        print(json.dumps(report['stitch_metrics'], indent=1))

    if args.jax_report:
        jax_report = json.loads(Path(args.jax_report).read_text())
        report['jax_report'] = args.jax_report
        theirs = {**jax_report.get('shape_metrics', {}), **jax_report.get('stitch_metrics', {})}
        rows += _compare_rows(ours, theirs, SHAPE_METRICS + STITCH_METRICS, 'jax')

    if args.expected:
        expected = json.loads(Path(args.expected).read_text())
        report['expected'] = expected
        rows += _compare_rows(ours, expected, list(expected), 'published')

    failed = []
    if rows:
        width = max(len(r[0]) for r in rows)
        print(f'\n{"metric".ljust(width)}  {"ours":>12}  {"reference":>12}  delta   bar')
        for name, a, b, delta, extra in rows:
            bar = max(args.tolerance, extra)
            status = 'PASS' if delta <= bar else 'FAIL'
            print(f'{name.ljust(width)}  {a:12.5f}  {b:12.5f}  {delta:6.2%} {bar:6.2%} {status}')
            if delta > bar:
                failed.append(name)
        report['comparisons'] = [
            {'metric': n, 'ours': a, 'reference': b, 'delta': d,
             'bar': max(args.tolerance, e), 'pass': d <= max(args.tolerance, e)}
            for n, a, b, d, e in rows]

    Path(args.output).write_text(json.dumps(report, indent=1))
    print(f'parity_check::report -> {args.output}')
    if failed:
        print(f'parity_check::FAIL::{len(failed)} metric(s) beyond '
              f'{args.tolerance:.0%}: {failed}')
        return 1
    print('parity_check::all comparisons within tolerance')
    return 0


if __name__ == '__main__':
    sys.exit(main())
