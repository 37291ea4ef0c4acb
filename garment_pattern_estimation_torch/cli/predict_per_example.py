"""Predict sewing patterns for point clouds from outside the garment dataset
(.txt / .obj files), on the card unless `--device cpu` is given:

    python -m garment_pattern_estimation_torch.cli.predict_per_example \
        -sh configs/att.yaml -st configs/stitch_model.yaml -f cloud.txt

The port's counterpart of
garment_pattern_estimation_tpu/cli/predict_per_example.py: each cloud is
resampled to the run's `mesh_samples` points, standardized, predicted by
the shape run's best model and saved under `<output>/<save_tag>_<stamp>/shape/`;
with a stitch config, the stitch model classifies every edge pair of each
saved pattern and the patterns with those stitches go to `with_stitches/`.
"""
from __future__ import annotations

import argparse
from datetime import datetime
from pathlib import Path

import numpy as np

from .common import load_yaml, make_experiment, system_properties
from ..core import EmptyPanelError, InvalidPatternDefError, NNSewingPattern, PatternSpec
from ..data import save_garments_prediction
from ..device import resolve_device
from ..preprocess import mesh as mesh_ops
from ..train import make_predict_fn


def load_points_txt(filename):
    points = []
    with open(filename, 'r') as f:
        for line in f:
            coords = [float(x) for x in line.split()][:3]
            if coords:
                points.append(coords)
    return np.array(points)


def get_values_from_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-sh', '--shape_config', type=str, default='./configs/att.yaml')
    parser.add_argument('-st', '--stitch_config', type=str, default='')
    parser.add_argument('--file', '-f', type=str, default=None)
    parser.add_argument('--directory', '-dir', type=str, default=None)
    parser.add_argument('--save_tag', '-s', type=str, default='per_sample')
    parser.add_argument('--system', type=str, default='./system.json')
    parser.add_argument('--device', help="torch device (default: 'cuda'; 'cpu' runs "
                        'the plain PyTorch path)', type=str, default=None)
    args = parser.parse_args(argv)

    shape_config = load_yaml(args.shape_config)
    stitch_config = load_yaml(args.stitch_config) if args.stitch_config else None

    paths_list = []
    if args.file is None and args.directory is None:
        raise ValueError('No input point cloud samples are provided')
    if args.file is not None:
        paths_list.append(Path(args.file))
    if args.directory is not None:
        for elem in Path(args.directory).glob('*'):
            if elem.is_file() and elem.suffix in ('.txt', '.obj'):
                paths_list.append(elem)
    return shape_config, stitch_config, paths_list, args


def main(argv=None):
    shape_config, stitch_config, sample_paths, args = get_values_from_args(argv)
    system_info = system_properties(args.system)
    device = resolve_device(args.device)
    saving_path = Path(system_info['output']) / (
        args.save_tag + '_' + datetime.now().strftime('%y%m%d-%H-%M-%S'))
    saving_path.mkdir(parents=True)

    shape_experiment = make_experiment(shape_config, system_info)
    _, _, data_config = shape_experiment.data_info()

    # --- assemble the input batch ---
    points_list = []
    target = data_config.get('mesh_samples', 2000)
    for filename in sample_paths:
        if filename.suffix == '.obj':
            verts, faces = mesh_ops.read_triangle_mesh(str(filename))
            points = mesh_ops.sample_mesh_points(target, verts, faces, seed=601)
        else:
            points = load_points_txt(filename)
        if points.shape[0] != target:
            # the batch needs exact sizes: down-sample without replacement,
            # up-sample with it
            rng = np.random.default_rng(601)
            selection = rng.choice(points.shape[0], size=target,
                                   replace=points.shape[0] < target)
            if abs(points.shape[0] - target) > 10:
                print(f'Warning::input point cloud has {points.shape[0]} '
                      f'points while {target} are expected. Resampled.')
            points = points[selection]
        if 'standardize' in data_config:
            points = (points - np.asarray(data_config['standardize']['f_shift'])) \
                / np.asarray(data_config['standardize']['f_scale'])
        points_list.append(points.astype(np.float32))

    # --- shape prediction ---
    shape_model, shape_state = shape_experiment.load_model(data_config, device=device)
    predict_fn = make_predict_fn(shape_model, shape_state)
    predictions = predict_fn(np.stack(points_list))

    shape_dir = saving_path / 'shape'
    shape_dir.mkdir(parents=True, exist_ok=True)
    names = [PatternSpec.name_from_path(p) for p in sample_paths]
    save_garments_prediction(
        predictions, shape_dir, data_config, names,
        stitches_from_stitch_tags='stitch' in shape_experiment.NN_config()
        .get('loss', {}).get('loss_components', []))
    print(f'Pattern shape saved to {shape_dir}')

    # --- stitch prediction on the saved shapes ---
    if stitch_config:
        stitch_experiment = make_experiment(stitch_config, system_info)
        _, _, stitch_data_config = stitch_experiment.data_info()
        stitch_model, stitch_state = stitch_experiment.load_model(stitch_data_config,
                                                                  device=device)
        predict_logits = make_predict_fn(stitch_model, stitch_state, bucket_pairs=True)
        stats = stitch_data_config['standardize']

        stitch_dir = saving_path / 'with_stitches'
        stitch_dir.mkdir(parents=True, exist_ok=True)
        for name in names:
            spec_files = list((shape_dir / name).glob('*specification.json'))
            if not spec_files:
                continue
            pattern = NNSewingPattern(spec_files[0])
            try:
                pattern.stitches_from_pair_classifier(predict_logits, stats)
                pattern.serialize(stitch_dir, to_subfolder=True)
            except (InvalidPatternDefError, EmptyPanelError) as e:
                # a pattern the codec refuses; device errors are not caught
                print(f'predict_per_example::{name}::stitch prediction failed: {e}')
        print(f'Patterns with stitches saved to {stitch_dir}')
    return saving_path


if __name__ == '__main__':
    main()
