"""Training entry point, on the card unless `--device cpu` is given:

    python -m garment_pattern_estimation_torch.cli.train -c configs/att.yaml --system system.json

The port's counterpart of garment_pattern_estimation_tpu/cli/train.py. It
reads the same YAML schema (experiment / dataset + data_split / NN /
trainer sections) with the `old_experiment` flows of the dataset section:
`stats` reuses a previous run's data statistics and split, `weights`
starts from that run's best checkpoint, and `predictions` trains on a
finished shape run's predictions: the run's dataset and model are rebuilt,
every split section predicted and saved as `*_predicted_specification.json`,
the sections merged into one dataset root, and the stitch model trained on
it (the two-model pipeline handoff). The run ends with the best
checkpoint's metrics on the validation and test sections, whole and by
data folder.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .common import build_dataset, load_yaml, make_experiment, merge_repos, system_properties
from ..device import resolve_device
from ..models import build_model
from ..train import Trainer, eval_metrics, make_predict_fn


def get_values_from_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--config', '-c', help='YAML configuration file',
                        type=str, default='./configs/att.yaml')
    parser.add_argument('--system', help='system properties JSON',
                        type=str, default='./system.json')
    parser.add_argument('--device', help="torch device (default: 'cuda'; 'cpu' runs "
                        'the plain PyTorch path)', type=str, default=None)
    args = parser.parse_args(argv)
    return load_yaml(args.config), args


def get_old_data_config(in_config, system_info):
    """Pull data stats/config from a previous run (train.py:34-62)."""
    old_experiment = make_experiment(
        {'experiment': in_config['old_experiment']}, system_info)
    split, _, data_config = old_experiment.data_info()
    minimal = {
        key: data_config.get(key) for key in (
            'standardize', 'max_pattern_len', 'max_panel_len', 'max_num_stitches',
            'max_datapoints_per_type', 'panel_classification', 'filter_by_params',
            'mesh_samples', 'obj_filetag')
    }
    minimal['point_noise_w'] = data_config.get('point_noise_w', 0)
    in_config.update({k: v for k, v in minimal.items() if v is not None})
    return split, in_config


def predict_old_experiment(old, system_info, datasets_path, device):
    """Predict every split section of the finished shape run `old` (its
    experiment section) with its best checkpoint, save the predicted specs
    under the output root and merge the sections into one dataset root.
    Returns that root."""
    shape_experiment = make_experiment({'experiment': old}, system_info)
    shape_dataset, shape_wrapper = shape_experiment.load_dataset(datasets_path)
    shape_model, shape_state = shape_experiment.load_model(shape_dataset.config,
                                                           device=device)
    predict_fn = make_predict_fn(shape_model, shape_state)
    sections = ['train', 'validation', 'test']
    pred_path = shape_experiment.prediction(
        Path(system_info['output']), predict_fn, shape_wrapper, nick='',
        sections=sections)
    return merge_repos(pred_path, sections)


def main(argv=None):
    np.set_printoptions(precision=4, suppress=True)
    config, args = get_values_from_args(argv)
    system_info = system_properties(args.system)
    device = resolve_device(args.device)

    experiment = make_experiment(config, system_info)
    datasets_path = Path(system_info['datasets_path'])

    # --- old-experiment dataflows ---
    dataset_section = config['dataset']
    old = dataset_section.get('old_experiment')
    if old and old.get('predictions'):
        datasets_path = predict_old_experiment(old, system_info, datasets_path, device)
    if old and old.get('stats'):
        old_split, config['dataset'] = get_old_data_config(dataset_section, system_info)
        # fine-tuning (weights: true) on a different dataset composition
        # keeps its OWN split when one is given: the stored split indexes
        # the source run's folders and would drop every new-type datapoint
        if not (old.get('weights') and config.get('data_split')):
            config['data_split'] = old_split

    dataset = build_dataset(config, system_info, datasets_path)

    # --- trainer ---
    trainer = Trainer(config['trainer'], experiment, dataset,
                      config.get('data_split', {}), with_norm=True,
                      with_visualization=config['trainer'].get('with_visualization', False),
                      device=device)
    trainer.init_randomizer()

    # --- model ---
    model_name = config['NN'].get('model', 'GarmentSegmentPattern3D')
    model = build_model(model_name, dataset.config, config['NN'],
                        config['NN'].get('loss', {}), device=device,
                        seed=trainer.setup['random_seed'])
    model.loss.with_quality_eval = True

    # record canonicalization flags into the dataset config: prediction
    # saving must not propagate GT stitch/edge ids for models trained with
    # order/origin matching (their panel slots are arbitrary)
    dataset.config['order_matching'] = bool(
        model.loss.config.get('panel_order_inariant_loss', False))
    dataset.config['origin_matching'] = bool(
        model.loss.config.get('panel_origin_invariant_loss', False))

    # --- warm start (fine-tuning) ---
    # `dataset.old_experiment.weights: true` initializes from that run's
    # best checkpoint: a fresh run id, optimizer and schedule, pre-trained
    # parameters; pair with `stats: true` so the new run keeps the
    # standardization the weights were fit under
    warm_state = None
    if old and old.get('weights'):
        source = make_experiment({'experiment': old}, system_info)
        warm_state = source.get_best_model(map_location=device)['model']
        print(f'Train::warm start from {source.full_name()} (best checkpoint)')

    # --- train ---
    state = trainer.fit(model, state=warm_state)

    # --- final evaluation on the best checkpoint ---
    try:
        state = experiment.get_best_model(map_location=device)['model']
    except (FileNotFoundError, KeyError) as e:
        print(e)
        print('Train::Warning::evaluating with the current (final) model state')

    if config['trainer'].get('f32_tail_epochs') and config['NN'].get('compute_dtype'):
        # the best checkpoint of a bf16 + tail run comes from the f32 tail:
        # evaluate it at f32 too, not through the bf16 forward
        print('Train::f32 tail run: final eval with an f32 forward')
        model = build_model(model_name, dataset.config,
                            dict(config['NN'], compute_dtype=None),
                            config['NN'].get('loss', {}), device=device)
        model.loss.with_quality_eval = True

    datawrapper = trainer.datawrapper
    for tag, section, log in (('valid_on_best', 'validation', 'Validation metrics'),
                              ('valid', 'valid_per_data_folder',
                               'Validation metrics breakdown'),
                              ('test_on_best', 'test', 'Test metrics'),
                              ('test', 'test_per_data_folder', 'Test metrics breakdown')):
        experiment.add_statistic(tag, eval_metrics(model, state, datawrapper, section),
                                 log=log)
    experiment.stop()
    return experiment


if __name__ == '__main__':
    main()
