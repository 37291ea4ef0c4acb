"""One-command reference-parity check (BASELINE.json north star: panel L2
and stitch F1 within 1% of the reference), on the card unless `--device
cpu` is given:

    python -m garment_pattern_estimation_torch.cli.parity_check \
        --dataset_root /data/garment_datasets \
        --shape_pth  .../neural_tailor_panels.pth \
        --stitch_pth .../neural_tailor_stitch_model.pth \
        [--expected published_metrics.json] [--jax_report parity_report.json]

The port's counterpart of garment_pattern_estimation_tpu/cli/parity_check.py,
flag for flag where the mode's other side is in the port, with a report of
the same keys. Comparison modes, composable:
  * absolute metrics table: panel L2, #panels/#edges accuracy, placement
    L2 on the test split (`shape_metrics`); with `--stitch_pth`, stitch
    precision/recall/F1 and pair accuracy on the shape model's predictions
    (`stitch_metrics`);
  * `--expected`: against a {metric: value} JSON of published reference
    numbers, PASS/FAIL at `--tolerance` (default 1%);
  * `--jax_report`: against the report the JAX CLI wrote on the same
    checkpoints, dataset and split, row `jax:<metric>` per shape and stitch
    metric at `--tolerance`: the port held to the JAX package without
    importing it (the JAX CLI's `--torch_from_report` likewise reuses
    another report's columns).
Any failed row makes the exit code 1.

Precision: the JAX CLI forces `jax.default_matmul_precision('highest')`;
the port's package turns TF32 off when it is imported, so every matmul here
is full f32 already, and this CLI keeps it off.

Not ported: the replica modes (`--torch_cross_check`,
`--torch_train_cross_check`, `--stitch_train_cross_check`, `--noise_floor`,
`--noise_seeds`, `--jax_seeds`, `--resume`, `--stop_after_jax`,
`--torch_from_report`, with `--train_epochs` and `--train_seed`). Each
trains or replays the JAX package's torch reference replica
(experiment/torch_reference.py), which the port leaves out: its parity is
held against the JAX package. The parser does not know them, so it refuses
them.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .common import load_yaml
from ..data import DATASET_REGISTRY, DatasetWrapper, GarmentStitchPairsDataset
from ..device import resolve_device
from ..experiment.torch_import import load_checkpoint_any
from ..models import build_model
from ..train import eval_metrics, make_predict_fn

SHAPE_METRICS = ('panel_shape_l2', 'num_panels_accuracy', 'num_edges_accuracy',
                 'rotation_l2', 'translation_l2')
STITCH_METRICS = ('stitch_precision', 'stitch_recall', 'stitch_f1',
                  'edge_pair_class_acc')


def get_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--dataset_root', required=True)
    parser.add_argument('--shape_config', default='./configs/att.yaml')
    parser.add_argument('--shape_pth', required=True,
                        help='reference shape checkpoint (.pth) or a port checkpoint')
    parser.add_argument('--stitch_config', default='./configs/stitch_model.yaml')
    parser.add_argument('--stitch_pth', default='',
                        help='reference stitch checkpoint; omit to skip stage 2')
    parser.add_argument('--expected', default='',
                        help='JSON of published metric values to compare against')
    parser.add_argument('--jax_report', default='',
                        help="the JAX CLI's report on the same checkpoints, dataset and "
                             'split: its shape and stitch metrics become jax:<metric> rows')
    parser.add_argument('--tolerance', type=float, default=0.01)
    parser.add_argument('--max_datapoints', type=int, default=None,
                        help='cap per-type datapoints (quick smoke runs)')
    parser.add_argument('--output', default='./parity_report.json')
    parser.add_argument('--device', default=None,
                        help="torch device (default: 'cuda'; 'cpu' runs the plain "
                             'PyTorch path)')
    return parser.parse_args(argv)


def _build_shape_stack(args, device):
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
    state = _module_state(model, load_checkpoint_any(args.shape_pth)['model'])
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


def _compare_rows(ours, other, keys, label):
    """Rows of (name, ours, reference, delta) for the keys both sides have;
    delta relative to the reference, floored at 1e-3 (accuracies near 0)."""
    rows = []
    for key in keys:
        a, b = ours.get(key), other.get(key)
        if a is None or b is None:
            continue
        rows.append((f'{label}:{key}', a, b, abs(a - b) / max(abs(b), 1e-3)))
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
    metrics = eval_metrics(stitch_model, stitch_state, stitch_wrapper, 'full')
    p, r = metrics.get('stitch_precision'), metrics.get('stitch_recall')
    if p is not None and r is not None:
        metrics['stitch_f1'] = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    return {k: metrics.get(k) for k in STITCH_METRICS if k in metrics}


def main(argv=None):
    args = get_args(argv)
    device = resolve_device(args.device)
    report = {'dataset_root': args.dataset_root, 'shape_pth': args.shape_pth}
    rows = []
    _, _, wrapper, model, state = _build_shape_stack(args, device)

    print('parity_check::evaluating shape model on the test split')
    ours = eval_metrics(model, state, wrapper, 'test')
    report['shape_metrics'] = {k: ours.get(k) for k in SHAPE_METRICS if k in ours}
    print(json.dumps(report['shape_metrics'], indent=1))

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
        for name, a, b, delta in rows:
            status = 'PASS' if delta <= args.tolerance else 'FAIL'
            print(f'{name.ljust(width)}  {a:12.5f}  {b:12.5f}  {delta:6.2%} '
                  f'{args.tolerance:6.2%} {status}')
            if delta > args.tolerance:
                failed.append(name)
        report['comparisons'] = [
            {'metric': n, 'ours': a, 'reference': b, 'delta': d, 'bar': args.tolerance,
             'pass': d <= args.tolerance} for n, a, b, d in rows]

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
