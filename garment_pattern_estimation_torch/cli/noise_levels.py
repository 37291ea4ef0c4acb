"""Robustness sweep over point-cloud noise levels, on the card unless
`--device cpu` is given:

    python -m garment_pattern_estimation_torch.cli.noise_levels -sh configs/att.yaml

The port's counterpart of garment_pattern_estimation_tpu/cli/noise_levels.py:
re-evaluates the shape model's test section (or the unseen types' with
`--unseen`) with the dataset's sampling noise `point_noise_w` at each level,
loading the model once, and dumps the per-level metric summaries into
`<output>/noise_levels_summary.json`.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from .common import load_yaml, make_experiment, system_properties
from ..device import resolve_device
from ..train import eval_metrics

NOISE_LEVELS = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('-sh', '--shape_config', type=str, default='./configs/att.yaml')
    parser.add_argument('-u', '--unseen', action='store_true')
    parser.add_argument('--levels', type=float, nargs='*', default=NOISE_LEVELS)
    parser.add_argument('--system', type=str, default='./system.json')
    parser.add_argument('--device', help="torch device (default: 'cuda'; 'cpu' runs "
                        'the plain PyTorch path)', type=str, default=None)
    args = parser.parse_args(argv)

    shape_config = load_yaml(args.shape_config)
    system_info = system_properties(args.system)
    device = resolve_device(args.device)
    experiment = make_experiment(shape_config, system_info)
    section = 'full' if args.unseen else 'test'

    summaries = {}
    model = state = None
    for level in args.levels:
        dataset, wrapper = experiment.load_dataset(
            Path(system_info['datasets_path']),
            {'obj_filetag': 'sim', 'point_noise_w': level}, unseen=args.unseen)
        if model is None:
            # only the dataset's noise changes between levels: load once
            model, state = experiment.load_model(dataset.config, device=device)
        metrics = eval_metrics(model, state, wrapper, section)
        summaries[str(level)] = metrics
        print(f'noise {level}: {metrics}')
        experiment.add_statistic(f'noise_{level}', metrics)

    out_file = Path(system_info['output']) / 'noise_levels_summary.json'
    out_file.parent.mkdir(parents=True, exist_ok=True)
    with open(out_file, 'w') as f:
        json.dump(summaries, f, indent=2)
    print(f'Saved {out_file}')
    return summaries


if __name__ == '__main__':
    main()
