"""The port's evaluation and prediction paths against the JAX package's:
the tracker's `load_dataset` overrides, the `NN.pre-trained` fallback of
`get_best_model` (a reference-style `.pth`), and the `on_test_set`,
`predict_per_example` and `noise_levels` CLIs.

Both packages evaluate one shape run and one stitch run. Each run is a run
directory with its data config, split and NN section, and no checkpoint:
its `NN.pre-trained` names one reference-style `.pth` (`{'model_state_dict':
{'module.' + name: ...}, 'epoch': 3}`) written from seeded JAX variables, so
both packages load the same weights through their own fallback. The shape
model is tests/test_torch_fit.py's tiny attention model with zero LSTM
initial states (both evaluations are deterministic); the JAX side runs its
plain path. The synthetic root carries scan meshes for `--filetag scan`.
An untrained shape model predicts no stitched pattern, so the stitch stage
reads `--pred_path`: a copy of the synthetic data folders under `test/`
(the stitch dataset falls back to `specification.json`), each spec marked
with a `correct_num_panels`, wrong for every other garment, for
`--correct_panels`.

Tolerances: metric values within VALID_RTOL = 1e-3 relative (as
tests/test_torch_fit.py's validation losses; metrics that are 0 within
1e-6); forwards within tests/test_torch_model.py's bars (1e-2 of the
output's scale at most, 1e-4 on average); predicted outlines (panel
vertices in physical units) within the same bars; file names exactly.
"""
import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from garment_pattern_estimation_torch import data as pt_data
from garment_pattern_estimation_torch import experiment as pt_experiment
from garment_pattern_estimation_torch.cli import noise_levels as pt_noise_levels
from garment_pattern_estimation_torch.cli import on_test_set as pt_on_test_set
from garment_pattern_estimation_torch.cli import predict_per_example as pt_predict
from garment_pattern_estimation_torch.experiment.torch_import import load_checkpoint_any
from garment_pattern_estimation_torch.models.flax_import import state_dict_from_flax
from garment_pattern_estimation_tpu import data as jx_data
from garment_pattern_estimation_tpu import experiment as jx_experiment
from garment_pattern_estimation_tpu.cli import noise_levels as jx_noise_levels
from garment_pattern_estimation_tpu.cli import on_test_set as jx_on_test_set
from garment_pattern_estimation_tpu.cli import predict_per_example as jx_predict
from garment_pattern_estimation_tpu.experiment.torch_import import (import_shape_model,
                                                                     import_stitch_model)
from garment_pattern_estimation_tpu.models import build_model as jx_build_model
from test_torch_fit import FOLDERS, LOSS, NN, SPLIT
from test_torch_model import assert_close_to_scale

torch.set_num_threads(1)

VALID_RTOL = 1e-3
UNSEEN = ['skirt_synth_300']
SHAPE_NN = dict(NN, model='GarmentSegmentPattern3D', loss=LOSS)
STITCH_NN = {'model': 'StitchOnEdge3DPairs', 'stitch_hidden_size': 32, 'stitch_mlp_n_layers': 2,
             'loss': {'loss_components': ['edge_pair_class'],
                      'quality_components': ['edge_pair_class', 'edge_pair_stitch_recall']}}
STITCH_DATA = {'data_folders': FOLDERS, 'random_pairs_mode': True, 'stitched_edge_pairs_num': 10,
               'non_stitched_edge_pairs_num': 10, 'pairs_seed': 3}
PACKAGES = {'jax': (jx_data, jx_experiment), 'port': (pt_data, pt_experiment)}
DEVICE = {'jax': [], 'port': ['--device', 'cpu']}


def _shape_dataset(data, root):
    return data.Garment3DPatternFullDataset(
        root, {'data_folders': FOLDERS, 'mesh_samples': 60, 'unseen_data_folders': UNSEEN,
               'panel_classification': str(root / 'panel_classes.json')},
        gt_caching=True, feature_caching=True)


def _stitch_dataset(data, root):
    return data.GarmentStitchPairsDataset(root, dict(STITCH_DATA), gt_caching=True,
                                          feature_caching=True)


def _make_run(package, out, name, dataset, nn_config):
    """A run directory as a finished training run leaves it, less its
    checkpoints: config (dataset with statistics, split, trainer, NN),
    artifacts, the finished marker."""
    data, experiment = PACKAGES[package]
    wrapper = data.DatasetWrapper(dataset)
    wrapper.load_split(dict(SPLIT))
    wrapper.new_loaders(4)
    wrapper.standardize_data()
    exp = experiment.ExperimentWrappper(
        {'experiment': {'project_name': 'eval', 'run_name': name, 'run_id': name}},
        output_root=out / 'experiments')
    exp.init_run({'trainer': {'batch_size': 4}})
    wrapper.save_to_wandb(exp)
    exp.add_config('NN', nn_config)
    exp.stop()
    return exp


def _write_pth(path, state):
    torch.save({'model_state_dict': {'module.' + k: v for k, v in state.items()},
                'epoch': 3}, path)


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    """The scan-carrying synthetic root, the two `.pth` files, both
    packages' shape and stitch runs, their CLI configs and system files,
    and the `--pred_path` folder."""
    import jax
    from garment_pattern_estimation_tpu.utils import synthetic

    base = tmp_path_factory.mktemp('evaluation')
    root = base / 'data'
    synthetic.generate_dataset(root, samples_per_folder=6, seed=7, with_scan=True)
    synthetic.panel_classes_for_templates(root / 'panel_classes.json')

    dataset = _shape_dataset(jx_data, root)
    wrapper = jx_data.DatasetWrapper(dataset)
    wrapper.load_split(dict(SPLIT))
    wrapper.standardize_data()
    model = jx_build_model('GarmentSegmentPattern3D', dataset.config, NN, LOSS,
                           use_pallas=False)
    variables = jax.tree_util.tree_map(np.asarray, model.init_variables(
        jax.random.PRNGKey(3), np.asarray(dataset[0]['features'][None])))
    rng = np.random.default_rng(11)
    stitch_variables = {'params': {'mlp': {}}, 'batch_stats': {'mlp': {}}}
    sizes = [16, 32, 32, 1]
    for j, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        stitch_variables['params']['mlp'][f'Dense_{j}'] = {
            'kernel': (rng.normal(size=(fan_in, fan_out)) / np.sqrt(fan_in)).astype(np.float32),
            'bias': (0.1 * rng.normal(size=fan_out)).astype(np.float32)}
        stitch_variables['params']['mlp'][f'BatchNorm_{j}'] = {
            'scale': rng.uniform(0.5, 1.5, fan_out).astype(np.float32),
            'bias': (0.1 * rng.normal(size=fan_out)).astype(np.float32)}
        stitch_variables['batch_stats']['mlp'][f'BatchNorm_{j}'] = {
            'mean': rng.uniform(0.0, 0.5, fan_out).astype(np.float32),
            'var': rng.uniform(0.5, 2.0, fan_out).astype(np.float32)}
    shape_pth, stitch_pth = base / 'shape.pth', base / 'stitch.pth'
    _write_pth(shape_pth, state_dict_from_flax(variables))
    _write_pth(stitch_pth, state_dict_from_flax(stitch_variables))

    # --pred_path: the data folders under test/, each spec with a
    # correct_num_panels (wrong for every other garment)
    pred_path = base / 'pred_path'
    for folder in FOLDERS:
        shutil.copytree(root / folder, pred_path / 'test' / folder)
        for i, spec in enumerate(sorted((pred_path / 'test' / folder).glob('*/specification.json'))):
            content = json.loads(spec.read_text())
            content.setdefault('properties', {})['correct_num_panels'] = \
                len(content['pattern']['panels']) + i % 2
            spec.write_text(json.dumps(content))

    runs, configs, systems = {}, {}, {}
    for package, (data, _) in PACKAGES.items():
        out = base / package
        runs[package] = {
            'shape': _make_run(package, out, 'shape', _shape_dataset(data, root),
                               dict(SHAPE_NN, **{'pre-trained': str(shape_pth)})),
            'stitch': _make_run(package, out, 'stitch', _stitch_dataset(data, root),
                                dict(STITCH_NN, **{'pre-trained': str(stitch_pth)}))}
        systems[package] = out / 'system.json'
        systems[package].write_text(json.dumps({'datasets_path': str(root),
                                                'output': str(out)}))
    for name in ('shape', 'stitch'):
        configs[name] = base / f'{name}.yaml'
        configs[name].write_text(yaml.safe_dump(
            {'experiment': {'project_name': 'eval', 'run_name': name, 'run_id': name}}))
    return {'root': root, 'base': base, 'runs': runs, 'configs': configs, 'systems': systems,
            'pred_path': pred_path, 'variables': variables,
            'stitch_variables': stitch_variables, 'shape_pth': shape_pth,
            'stitch_pth': stitch_pth}


def _summary(package, env, name):
    exp = env['runs'][package][name]
    return json.loads((exp.run_dir() / 'summary.json').read_text())


def _assert_metrics_close(ours, theirs, prefixes):
    """The same keys under `prefixes`; numbers within VALID_RTOL."""
    ours = {k: v for k, v in ours.items() if k.startswith(prefixes)}
    theirs = {k: v for k, v in theirs.items() if k.startswith(prefixes)}
    assert sorted(ours) == sorted(theirs)
    assert ours
    for key, value in ours.items():
        if isinstance(value, dict):
            continue
        if value is None or theirs[key] is None:
            assert value == theirs[key], key
        else:
            assert value == pytest.approx(theirs[key], rel=VALID_RTOL, abs=1e-6), key


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob('*') if p.is_file())


def _only(pattern, root):
    found = sorted(Path(root).glob(pattern))
    assert len(found) == 1, found
    return found[0]


def _comparable(config):
    """A data config as JSON, less the path of the run's own copy of the
    panel classes (each package's run directory)."""
    assert config['panel_classification'].endswith('artifacts/panel_classes.json')
    config = {k: v for k, v in config.items() if k != 'panel_classification'}
    return json.loads(json.dumps(config, default=lambda v: np.asarray(v).tolist()))


@pytest.mark.parametrize('overrides', [
    {}, {'eval_config': {'obj_filetag': 'scan', 'point_noise_w': 0.1}},
    {'unseen': True}, {'batch_size': 2}, {'load_all': True}])
def test_load_dataset_overrides_match_jax(env, overrides):
    """Split sizes, batch size and data config of the rebuilt dataset."""
    results = {}
    for package in PACKAGES:
        dataset, wrapper = env['runs'][package]['shape'].load_dataset(env['root'],
                                                                         **overrides)
        results[package] = (_comparable(dataset.config), wrapper.batch_size,
                            [len(s) if s is not None else None
                             for s in (wrapper.training, wrapper.validation, wrapper.test)],
                            len(wrapper.get_loader('full')), dataset.datapoints_names)
    assert results['port'] == results['jax']
    config, batch_size, sizes, _, names = results['port']
    assert batch_size == overrides.get('batch_size', 4)
    if overrides.get('unseen'):
        assert {n.split('/')[0] for n in names} == set(UNSEEN)
    if overrides.get('unseen') or overrides.get('load_all'):
        assert sizes == [len(names), None, None]
    else:
        assert sizes[1:] == [3, 3]
    assert config['obj_filetag'] == overrides.get('eval_config', {}).get('obj_filetag', 'sim')


def test_pretrained_shape_fallback_matches_jax(env):
    """No 'best' checkpoint: the port's `get_best_model` loads the run's
    reference `.pth`, and its forward equals the JAX package's on the
    variables `import_shape_model` reads from the same file."""
    exp = env['runs']['port']['shape']
    checkpoint = exp.get_best_model()
    assert checkpoint['epoch'] == 3 and not any(k.startswith('module.')
                                                for k in checkpoint['model'])
    _, _, data_config = exp.data_info()
    model, state = exp.load_model(data_config, device='cpu')
    assert state.keys() == checkpoint['model'].keys()
    # the Pallas kernel (interpret mode): the numerics the port's plain
    # fused layer follows
    jx_model = jx_build_model('GarmentSegmentPattern3D', data_config, NN, LOSS,
                              use_pallas=True)
    variables = import_shape_model(env['shape_pth'])['variables']
    x = np.random.default_rng(4).normal(size=(2, 60, 3)).astype(np.float32)
    theirs = jx_model.module.apply(variables, x, train=False)
    with torch.no_grad():
        ours = model.module(torch.from_numpy(x))
    assert sorted(ours) == sorted(theirs)
    for key in ours:
        assert_close_to_scale(ours[key].numpy(), np.asarray(theirs[key]))


def test_pretrained_stitch_fallback_matches_jax(env):
    exp = env['runs']['port']['stitch']
    _, _, data_config = exp.data_info()
    model, _ = exp.load_model(data_config, device='cpu')
    jx_model = jx_build_model('StitchOnEdge3DPairs', data_config, STITCH_NN, STITCH_NN['loss'])
    variables = import_stitch_model(env['stitch_pth'])['variables']
    x = np.random.default_rng(5).normal(size=(3, 40, 16)).astype(np.float32)
    theirs = np.asarray(jx_model.apply(variables, x, train=False))
    with torch.no_grad():
        ours = model.module(torch.from_numpy(x)).numpy()
    assert_close_to_scale(ours, theirs)


def test_load_checkpoint_any_reads_both_formats(env, tmp_path):
    """A bare reference state dict and a port checkpoint load too."""
    state = load_checkpoint_any(env['stitch_pth'])['model']
    bare = tmp_path / 'bare.pth'
    torch.save({'module.' + k: v for k, v in state.items()}, bare)
    loaded = load_checkpoint_any(bare)
    assert loaded['epoch'] is None
    assert all(torch.equal(loaded['model'][k], v) for k, v in state.items())
    port_file = pt_experiment.save_checkpoint_file({'model': state, 'epoch': 5},
                                                   tmp_path / 'checkpoint_5.pt')
    assert load_checkpoint_any(port_file)['epoch'] == 5
    with pytest.raises(FileNotFoundError):
        load_checkpoint_any(tmp_path / 'missing.pth')


@pytest.fixture(scope='module')
def pallas_jax():
    """The JAX package's models built with its Pallas kernels (interpret
    mode on the CPU), as its own tests run them: the numerics the port's
    plain fused layer follows (the JAX plain path skips the kernel's bf16
    truncations). Its CLIs build their models with `use_pallas=None`,
    which means the plain path off the TPU."""
    import garment_pattern_estimation_tpu.models as jx_models

    build = jx_models.build_model

    def with_pallas(*args, use_pallas=None, **kwargs):
        return build(*args, use_pallas=True if use_pallas is None else use_pallas, **kwargs)

    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(jx_models, 'build_model', with_pallas)
        yield


@pytest.fixture(scope='module')
def on_test_set_runs(env, pallas_jax):
    """Both CLIs: the shape stage with `--predict`, again with
    `--filetag scan`, then the stitch stage on `--pred_path` with
    `--predict --correct_panels`."""
    for package, cli in (('jax', jx_on_test_set), ('port', pt_on_test_set)):
        common = ['--system', str(env['systems'][package])] + DEVICE[package]
        cli.main(['-sh', str(env['configs']['shape']), '--predict'] + common)
        cli.main(['-sh', str(env['configs']['shape']), '--filetag', 'scan'] + common)
        cli.main(['-sh', str(env['configs']['shape']), '-st', str(env['configs']['stitch']),
                  '--pred_path', str(env['pred_path']), '--predict', '--correct_panels']
                 + common)
    return env


def test_on_test_set_shape_metrics_match_jax(on_test_set_runs):
    env = on_test_set_runs
    ours, theirs = _summary('port', env, 'shape'), _summary('jax', env, 'shape')
    assert {'test_on_best', 'test', 'test_scan_on_best', 'test_scan'} <= set(ours)
    assert sorted(ours) == sorted(theirs)
    _assert_metrics_close(ours, theirs, ('test',))
    # the scan meshes give other metrics than the simulated ones
    assert ours['test_scan_on_best.full_loss'] != ours['test_on_best.full_loss']


def test_on_test_set_stitch_metrics_match_jax(on_test_set_runs):
    env = on_test_set_runs
    ours, theirs = _summary('port', env, 'stitch'), _summary('jax', env, 'stitch')
    assert {'test_preds_full', 'test_preds', 'test_corr_full', 'test_corr'} <= set(ours)
    assert sorted(ours) == sorted(theirs)
    _assert_metrics_close(ours, theirs, ('test_preds', 'test_corr'))


def test_on_test_set_predictions_match_jax(on_test_set_runs):
    """The shape predictions (`nn_test_pred_*/test/...`) and the stitch
    write-back (`nn_test_pred_*/full/...`) have the same files."""
    env = on_test_set_runs
    trees = {}
    for package in PACKAGES:
        out = env['base'] / package
        shape = _only('nn_test_pred_*/test', out)
        stitched = _only('nn_test_pred_*/full', out)
        trees[package] = (_tree(shape), _tree(stitched))
    assert trees['port'] == trees['jax']
    shape_files, stitched_files = trees['port']
    assert sum(f.endswith('_predicted__specification.json') for f in shape_files) == 3
    # every garment of pred_path but the one simulation failure per folder
    assert sum(f.endswith('_predicted__specification.json') for f in stitched_files) \
        == 5 * len(FOLDERS)


def _vertices(spec_file):
    panels = json.loads(spec_file.read_text())['pattern']['panels']
    return {name: np.asarray(panel['vertices']) for name, panel in sorted(panels.items())}


def test_predict_per_example_matches_jax(env, pallas_jax, tmp_path):
    """Two .obj files and one .txt cloud (75 points, resampled to 60) through
    the shape and the stitch stage: the same saved files and outlines."""
    inputs = tmp_path / 'inputs'
    inputs.mkdir()
    objs = sorted(env['root'].glob('*/*/*_sim.obj'))[:2]
    for obj in objs:
        shutil.copy(obj, inputs / obj.name)
    cloud = np.random.default_rng(6).normal(size=(75, 3)) * 10.0
    np.savetxt(inputs / 'cloud.txt', cloud)
    saved = {}
    for package, cli in (('jax', jx_predict), ('port', pt_predict)):
        saved[package] = Path(cli.main(
            ['-sh', str(env['configs']['shape']), '-st', str(env['configs']['stitch']),
             '-dir', str(inputs), '--system', str(env['systems'][package])]
            + DEVICE[package]))
    assert _tree(saved['port']) == _tree(saved['jax'])
    specs = sorted(saved['port'].glob('shape/*/*_specification.json'))
    assert len(specs) == 3
    for spec in specs:
        ours = _vertices(spec)
        theirs = _vertices(saved['jax'] / spec.relative_to(saved['port']))
        assert sorted(ours) == sorted(theirs)
        assert_close_to_scale(np.concatenate(list(ours.values())),
                              np.concatenate(list(theirs.values())))


def test_noise_levels_match_jax(env, pallas_jax):
    summaries = {}
    for package, cli in (('jax', jx_noise_levels), ('port', pt_noise_levels)):
        system = env['systems'][package]
        summaries[package] = cli.main(['-sh', str(env['configs']['shape']), '--levels',
                                       '0.0', '0.5', '--system', str(system)]
                                      + DEVICE[package])
        on_disk = json.loads((system.parent / 'noise_levels_summary.json').read_text())
        assert sorted(on_disk) == ['0.0', '0.5']
    assert sorted(summaries['port']) == sorted(summaries['jax'])
    for level, metrics in summaries['port'].items():
        _assert_metrics_close(metrics, summaries['jax'][level], ('',))
    assert summaries['port']['0.5']['full_loss'] != summaries['port']['0.0']['full_loss']
