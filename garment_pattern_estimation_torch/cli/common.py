"""Shared CLI plumbing: YAML config loading, system properties, the
experiment tracker and dataset factories, merging prediction sections.

The port's copy of garment_pattern_estimation_tpu/cli/common.py:11-62,
without the compilation cache (the port compiles no graph; its kernels
build once into `_build/`)."""
from __future__ import annotations

import shutil
from pathlib import Path

from ..core import Properties


def load_yaml(path):
    import yaml     # imported here: the library entry points need no PyYAML
    with open(path, 'r') as f:
        return yaml.safe_load(f)


def system_properties(path='./system.json'):
    """Machine-local paths (datasets_path, output) — reference: system.json.
    Falls back to ./data and ./output when the file is absent."""
    if Path(path).exists():
        return Properties(path)
    props = Properties()
    props.update({'datasets_path': './data', 'output': './output',
                  'wandb_username': 'local'})
    return props


def make_experiment(config, system, **kwargs):
    from ..experiment import ExperimentWrappper
    output_root = Path(system.get('output', './output')) / 'experiments'
    return ExperimentWrappper(config, output_root=output_root, **kwargs)


def build_dataset(config, system, datasets_path=None, gt_caching=True,
                  feature_caching=True):
    from ..data import DATASET_REGISTRY
    data_class = DATASET_REGISTRY[config['dataset'].get(
        'class', 'Garment3DPatternFullDataset')]
    root = Path(datasets_path or system['datasets_path'])
    return data_class(root, config['dataset'], gt_caching=gt_caching,
                      feature_caching=feature_caching)


def merge_repos(root, repos):
    """Merge prediction sections into one dataset root (train.py:65-75)."""
    root = Path(root)
    merge_target = root / 'merged'
    if merge_target.exists():
        # a fresh merge must not overlay a previous run's predictions:
        # copytree(dirs_exist_ok) would silently mix stale datapoints in
        shutil.rmtree(merge_target)
    merge_target.mkdir()
    for repo in repos:
        src = root / repo
        if src.exists():
            shutil.copytree(src, merge_target, dirs_exist_ok=True)
    return merge_target
