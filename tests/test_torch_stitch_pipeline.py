"""The port's stitch-model data path and train CLI against the JAX
package's, on the synthetic generator's data (6 garments per type).

* GarmentStitchPairsDataset: features and labels bitwise equal to the JAX
  dataset's with `pairs_seed` set, in the random-pairs mode (at the test's
  and at the published 200 + 200 pair counts) and in the exhaustive mode;
  the same stitch-less patterns dropped, predicted specs preferred, the
  same standardization statistics, the same stitches written back by
  `save_prediction_batch` for the same logits.
* The port's train CLI: a tiny shape run, then a tiny stitch run whose
  dataset section asks for `old_experiment.predictions` on it: the run
  files, the summary keys, the predicted specs on disk. The shape run
  trains 80 epochs at lr 0.005: a stitch run needs predicted patterns whose
  panels exist (a panel is dropped when its predicted edges are all within
  1.5 cm of zero, and a pattern loses its stitches with it), which a shape
  model trained for a few epochs does not yet give.
* The same tiny stitch config through the port's `cli.train` and the JAX
  package's, on a data root whose predicted specs already carry stitches:
  the same run files and summary keys.
* The shipped stitch configs parse and build unchanged, and chip_smoke.py's
  copy of configs/stitch_model.yaml equals the file.
"""
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from garment_pattern_estimation_tpu.cli import train as jax_train_cli
from garment_pattern_estimation_tpu.data import DatasetWrapper as JaxDatasetWrapper
from garment_pattern_estimation_tpu.data import (
    GarmentStitchPairsDataset as JaxGarmentStitchPairsDataset)
from garment_pattern_estimation_torch.cli import common
from garment_pattern_estimation_torch.cli import train as train_cli
from garment_pattern_estimation_torch.data import (
    DATASET_REGISTRY, DatasetWrapper, GarmentStitchPairsDataset)
from garment_pattern_estimation_torch.models import build_model

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FOLDERS = ['tee_synth_300', 'skirt_synth_300', 'jumpsuit_synth_300']
PAIRS = {'stitched_edge_pairs_num': 10, 'non_stitched_edge_pairs_num': 10, 'pairs_seed': 3}
SPLIT = {'valid_per_type': 1, 'test_per_type': 1, 'type': 'count', 'random_seed': 5}


def _both(root, config):
    return (GarmentStitchPairsDataset(root, config, gt_caching=True, feature_caching=True),
            JaxGarmentStitchPairsDataset(root, config, gt_caching=True, feature_caching=True))


def _assert_samples_equal(ours, theirs):
    assert ours.datapoints_names == theirs.datapoints_names
    assert ours.config == theirs.config
    for i in range(len(ours)):
        mine, ref = ours[i], theirs[i]
        for key in ('features', 'ground_truth'):
            assert mine[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(mine[key], ref[key], err_msg=f'{i} {key}')
        assert (mine['name'], mine['data_folder']) == (ref['name'], ref['data_folder'])


@pytest.mark.parametrize('pairs', [dict(PAIRS, random_pairs_mode=True),
                                   dict(PAIRS, stitched_edge_pairs_num=200,
                                        non_stitched_edge_pairs_num=200),
                                   dict(PAIRS, random_pairs_mode=False)],
                         ids=['random_10_10', 'random_200_200', 'exhaustive'])
def test_pairs_bitwise_equal_to_jax(synthetic_dataset_root, pairs):
    ours, theirs = _both(synthetic_dataset_root, {'data_folders': FOLDERS, **pairs})
    assert len(ours) == 15 and ours.config['element_size'] == 16
    _assert_samples_equal(ours, theirs)
    sample = ours[0]
    if pairs.get('random_pairs_mode', True):
        n = pairs['stitched_edge_pairs_num'] + pairs['non_stitched_edge_pairs_num']
        assert sample['features'].shape == (n, 16) and sample['ground_truth'].dtype == bool
        assert sample['ground_truth'].sum() == pairs['stitched_edge_pairs_num']
    else:
        counts = {ours[i]['features'].shape[0] for i in range(len(ours))}
        assert len(counts) > 1      # a different pair count per pattern


@pytest.fixture()
def predicted_root(synthetic_dataset_root, tmp_path):
    """A copy of the synthetic data where tee_00000 has a predicted spec
    without stitches (dropped) and skirt_00001 one with only its first two
    stitches (preferred over the ground truth's)."""
    root = tmp_path / 'data'
    shutil.copytree(synthetic_dataset_root, root)
    for name, keep in (('tee_synth_300/tee_00000', 0), ('skirt_synth_300/skirt_00001', 2)):
        spec = json.loads((root / name / 'specification.json').read_text())
        spec['pattern']['stitches'] = spec['pattern']['stitches'][:keep]
        (root / name / f'{name.split("/")[1]}_predicted__specification.json').write_text(
            json.dumps(spec))
    return root


def test_spec_path_prefers_predicted_specs(predicted_root):
    ours, _ = _both(predicted_root, {'data_folders': FOLDERS, **PAIRS})
    assert ours._spec_path('skirt_synth_300/skirt_00001').name \
        == 'skirt_00001_predicted__specification.json'
    assert ours._spec_path('skirt_synth_300/skirt_00002').name == 'specification.json'
    (predicted_root / 'tee_synth_300' / 'empty').mkdir()
    assert ours._spec_path('tee_synth_300/empty', missing_ok=True) is None
    with pytest.raises(RuntimeError, match='specification.json not found'):
        ours._spec_path('tee_synth_300/empty')


def test_filtering_and_standardization_match_jax(predicted_root):
    ours, theirs = _both(predicted_root, {'data_folders': FOLDERS, **PAIRS})
    assert 'tee_synth_300/tee_00000' not in ours.datapoints_names
    assert len(ours) == 14
    index = ours.datapoints_names.index('skirt_synth_300/skirt_00001')
    assert ours[index]['ground_truth'].sum() == PAIRS['stitched_edge_pairs_num']
    wrappers = (DatasetWrapper(ours), JaxDatasetWrapper(theirs))
    for wrapper in wrappers:
        wrapper.load_split(dict(SPLIT))
        wrapper.standardize_data()
    assert ours.config['standardize'] == theirs.config['standardize']
    assert len(ours.config['standardize']['f_shift']) == 16
    _assert_samples_equal(ours, theirs)
    batch = next(iter(wrappers[0].new_loaders(4)[0]))
    assert batch['features'].shape == (4, 20, 16) and batch['features'].dtype == torch.float32
    assert batch['ground_truth'].shape == (4, 20) and batch['ground_truth'].dtype == torch.bool


def test_save_prediction_batch_matches_jax(synthetic_dataset_root, tmp_path):
    """The same logits callable re-classifies the same patterns' stitches
    through both datasets; the written specs hold the same stitches."""
    ours, theirs = _both(synthetic_dataset_root, {'data_folders': FOLDERS, **PAIRS})
    for dataset in (ours, theirs):
        dataset.config['standardize'] = {'f_shift': [0.0] * 16, 'f_scale': [10.0] * 16}
    weights = np.random.default_rng(2).normal(size=16).astype(np.float32)

    def logits(pairs):
        return np.asarray(pairs) @ weights

    names = [n.split('/')[1] for n in ours.datapoints_names[::5]]
    folders = [n.split('/')[0] for n in ours.datapoints_names[::5]]
    for dataset, out in ((ours, tmp_path / 'ours'), (theirs, tmp_path / 'theirs')):
        dataset.save_prediction_batch(None, names, folders, out, model=logits,
                                      orig_folder_names=True)
    for name, folder in zip(names, folders):
        spec = f'{folder}/{name}/{name}_predicted__specification.json'
        mine = json.loads((tmp_path / 'ours' / spec).read_text())['pattern']['stitches']
        ref = json.loads((tmp_path / 'theirs' / spec).read_text())['pattern']['stitches']
        assert mine == ref and len(mine) > 0
        assert (tmp_path / 'ours' / folder / name / 'specification.json').exists()


def test_merge_repos_replaces_a_stale_merge(tmp_path):
    for section, name in (('train', 'a'), ('test', 'b')):
        (tmp_path / section / 'folder' / name).mkdir(parents=True)
    (tmp_path / 'merged' / 'folder' / 'stale').mkdir(parents=True)
    merged = common.merge_repos(tmp_path, ['train', 'validation', 'test'])
    assert sorted(p.name for p in (merged / 'folder').iterdir()) == ['a', 'b']


def test_stitch_configs_parse_and_build():
    """configs/stitch_model.yaml, demo_configs/stitch_demo.yaml and the
    shape configs load unchanged; the stitch model builds from them at its
    published widths (16 -> 200 -> 200 -> 200 -> 1, BN after each layer),
    its `pre-trained` path (outside the repository) unread; chip_smoke.py's
    copy of stitch_model.yaml's sections equals the file, less that path,
    and with the parameter filter the port's copy of the file it names
    (garment_pattern_estimation_torch/data_configs/)."""
    config = common.load_yaml(ROOT / 'configs' / 'stitch_model.yaml')
    assert DATASET_REGISTRY[config['dataset']['class']] is GarmentStitchPairsDataset
    assert config['dataset']['old_experiment']['predictions'] is True
    model = build_model(config['NN']['model'], {'element_size': 16}, config['NN'],
                        config['NN']['loss'], device='cpu')
    shapes = {k: tuple(v.shape) for k, v in model.module.state_dict().items()
              if k.endswith('0.weight')}
    assert shapes == {'mlp.0.0.weight': (200, 16), 'mlp.1.0.weight': (200, 200),
                      'mlp.2.0.weight': (200, 200), 'mlp.3.0.weight': (1, 200)}
    assert model.config['loss']['quality_components'] == [
        'edge_pair_class', 'edge_pair_stitch_recall']
    port_filter = config['dataset']['filter_by_params'].replace(
        'garment_pattern_estimation_tpu/', 'garment_pattern_estimation_torch/')
    assert chip_smoke.STITCH_DATASET == dict(config['dataset'], filter_by_params=port_filter)
    assert (ROOT / port_filter).read_bytes() \
        == (ROOT / config['dataset']['filter_by_params']).read_bytes()
    assert chip_smoke.STITCH_NN == {k: v for k, v in config['NN'].items()
                                    if k != 'pre-trained'}
    assert chip_smoke.STITCH_TRAINER == config['trainer']
    demo = common.load_yaml(ROOT / 'demo_configs' / 'stitch_demo.yaml')
    assert build_model(demo['NN']['model'], {'element_size': 16}, demo['NN'],
                       device='cpu').config['stitch_hidden_size'] == 64
    for name in ('att.yaml', 'att_bf16.yaml', 'lstm_stitch_tags.yaml'):
        shape = common.load_yaml(ROOT / 'configs' / name)
        assert shape['dataset']['class'] in DATASET_REGISTRY


def test_train_cli_needs_cuda_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    config = tmp_path / 'c.yaml'
    config.write_text(yaml.safe_dump({'experiment': {}, 'dataset': {}}))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_cli.main(['-c', str(config), '--system', str(tmp_path / 'none.json')])


SHAPE_CONFIG = {
    'experiment': {'project_name': 'stitch-cli', 'run_name': 'shape', 'run_id': None},
    'dataset': {'class': 'Garment3DPatternFullDataset', 'data_folders': FOLDERS,
                'mesh_samples': 60, 'obj_filetag': 'sim', 'point_noise_w': 0},
    'data_split': {'valid_per_type': 1, 'test_per_type': 1, 'type': 'count',
                   'random_seed': 10},
    'NN': {'model': 'GarmentSegmentPattern3D', 'conv_depth': 1, 'k_neighbors': 4,
           'EConv_hidden': 12, 'EConv_feature': 10, 'EConv_hidden_depth': 2,
           'skip_connections': True, 'local_attention': True,
           'panel_encoding_size': 16, 'panel_hidden_size': 16, 'panel_n_layers': 1,
           'lstm_init': 'kaiming_normal_',
           'loss': {'loss_components': ['shape', 'loop', 'rotation', 'translation'],
                    'quality_components': ['shape', 'discrete', 'rotation', 'translation'],
                    'epoch_with_stitches': 100, 'panel_origin_invariant_loss': False,
                    'panel_order_inariant_loss': False}},
    'trainer': {'batch_size': 3, 'epochs': 80, 'random_seed': 5, 'learning_rate': 0.005,
                'optimizer': 'Adam', 'weight_decay': 0, 'lr_scheduling': {'mode': '1cyclic'},
                'early_stopping': {'window': 1e-8, 'patience': 50},
                'with_visualization': False}}


def _stitch_config(shape_run_id):
    config = common.load_yaml(ROOT / 'demo_configs' / 'stitch_demo.yaml')
    config['experiment']['project_name'] = 'stitch-cli'
    config['dataset']['old_experiment'].update(project_name='stitch-cli', run_name='shape',
                                               run_id=shape_run_id)
    config['data_split'].update(valid_per_type=1, test_per_type=1)
    config['NN']['stitch_hidden_size'] = 16
    config['trainer'].update(batch_size=3, epochs=2)
    return config


def _run_cli(main, workdir, root, extra_args=()):
    """Shape run, then a stitch run on its predictions, in `workdir`."""
    workdir.mkdir()
    system = workdir / 'system.json'
    system.write_text(json.dumps({'datasets_path': str(root),
                                  'output': str(workdir / 'output')}))
    (workdir / 'shape.yaml').write_text(yaml.safe_dump(SHAPE_CONFIG))
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        shape = main(['-c', 'shape.yaml', '--system', str(system), *extra_args])
        (workdir / 'stitch.yaml').write_text(yaml.safe_dump(_stitch_config(shape.run_id)))
        stitch = main(['-c', 'stitch.yaml', '--system', str(system), *extra_args])
    finally:
        os.chdir(cwd)
    return shape, stitch


@pytest.fixture(scope='module')
def cli_runs(synthetic_dataset_root, tmp_path_factory):
    work = tmp_path_factory.mktemp('stitch_cli')
    return work, _run_cli(train_cli.main, work / 'port', synthetic_dataset_root,
                          ('--device', 'cpu'))


def _summary(experiment):
    return json.loads((experiment.run_dir() / 'summary.json').read_text())


def test_train_cli_stitch_pipeline(cli_runs):
    work, (shape, stitch) = cli_runs
    run_dir = stitch.run_dir()
    for name in ('config.json', 'summary.json', 'metrics.jsonl', 'finished.marker',
                 'checkpoints/aliases.json', 'artifacts/data_split.json'):
        assert (run_dir / name).exists(), name
    config = json.loads((run_dir / 'config.json').read_text())
    assert config['NN']['model'] == 'StitchOnEdge3DPairs'
    assert config['dataset']['class'] == 'GarmentStitchPairsDataset'
    summary = _summary(stitch)
    assert 0.0 <= summary['test_on_best.edge_pair_class_acc'] <= 1.0
    for folder in FOLDERS:
        for key in ('edge_pair_class_acc', 'edge_pair_class_loss', 'stitch_recall',
                    'stitch_precision', 'full_loss'):
            assert f'valid.{folder}.{key}' in summary
    # the shape run's predictions, saved and merged into the stitch data root
    prediction_path = Path(_summary(shape)['prediction_path'])
    assert prediction_path.parent == work / 'port' / 'output'
    predicted = sorted(prediction_path.glob('merged/*/*/*_predicted__specification.json'))
    assert len(predicted) == 15
    with_stitches = [p for p in predicted
                     if json.loads(p.read_text())['pattern']['stitches']]
    assert len(with_stitches) >= 10
    for section in ('train', 'validation', 'test'):
        assert list(prediction_path.glob(f'{section}/*/*/*_predicted__specification.json'))
    records = [json.loads(line) for line in
               (run_dir / 'metrics.jsonl').read_text().splitlines()]
    assert all({'edge_pair_class_acc', 'stitch_recall'} <= set(r) for r in records
               if 'batch' in r)


def test_train_cli_keys_match_jax(predicted_root, tmp_path):
    """The stitch config without `old_experiment.predictions`, on a data
    root whose predicted specs carry stitches, through both train CLIs."""
    runs = []
    for main, name, extra_args in ((train_cli.main, 'port', ('--device', 'cpu')),
                                   (jax_train_cli.main, 'jax', ())):
        workdir = tmp_path / name
        workdir.mkdir()
        system = workdir / 'system.json'
        system.write_text(json.dumps({'datasets_path': str(predicted_root),
                                      'output': str(workdir / 'output')}))
        config = _stitch_config(None)
        config['dataset']['old_experiment']['predictions'] = False
        (workdir / 'stitch.yaml').write_text(yaml.safe_dump(config))
        runs.append(main(['-c', str(workdir / 'stitch.yaml'), '--system', str(system),
                          *extra_args]))
    ours, theirs = runs
    assert json.loads((ours.run_dir() / 'config.json').read_text())['dataset']['class'] \
        == 'GarmentStitchPairsDataset'
    assert 'test_on_best.edge_pair_class_acc' in _summary(ours)
    assert set(_summary(ours)) == set(_summary(theirs))
    assert sorted(p.name for p in ours.run_dir().iterdir()) \
        == sorted(p.name for p in theirs.run_dir().iterdir())


def test_train_cli_stats_and_weights_flows(cli_runs, synthetic_dataset_root):
    """`old_experiment` with `stats` and `weights`: the new run takes the
    shape run's statistics and split and starts from its best checkpoint."""
    work, (shape, _) = cli_runs
    workdir = work / 'port'
    config = dict(SHAPE_CONFIG, trainer=dict(SHAPE_CONFIG['trainer'], epochs=1))
    config['experiment'] = dict(SHAPE_CONFIG['experiment'], run_name='finetune')
    config['dataset'] = dict(SHAPE_CONFIG['dataset'], old_experiment=dict(
        SHAPE_CONFIG['experiment'], run_id=shape.run_id, stats=True, weights=True))
    config.pop('data_split')
    (workdir / 'finetune.yaml').write_text(yaml.safe_dump(config))
    finetune = train_cli.main(['-c', str(workdir / 'finetune.yaml'),
                               '--system', str(workdir / 'system.json'), '--device', 'cpu'])
    stored = json.loads((finetune.run_dir() / 'config.json').read_text())
    source = json.loads((shape.run_dir() / 'config.json').read_text())
    assert stored['dataset']['standardize'] == source['dataset']['standardize']
    splits = [json.loads((run.run_dir() / 'artifacts' / 'data_split.json').read_text())
              for run in (finetune, shape)]
    assert [{k: set(v) for k, v in split.items()} for split in splits][0] \
        == {k: set(v) for k, v in splits[1].items()}
    assert (finetune.run_dir() / 'finished.marker').exists()
