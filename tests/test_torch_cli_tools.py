"""The port's profiler window (`trainer.profile`) and its two host CLIs,
`cli/att_weights_viz.py` and `cli/utility_scripts.py`, against the JAX
package's.

The profiler traces `fit` on the CPU here (CPU activity only), so the test
holds the window's placement and its files, not device times. The CLIs are
numpy and matplotlib on both sides, so their outputs must be equal: the same
PNG, the same counts, the same points, archives that unpack to the same
bytes.
"""
import builtins
import filecmp
import json

import numpy as np
import pytest
import torch

from garment_pattern_estimation_torch import data as pt_data
from garment_pattern_estimation_torch import experiment as pt_experiment
from garment_pattern_estimation_torch.cli import att_weights_viz as pt_viz
from garment_pattern_estimation_torch.cli import utility_scripts as pt_utils
from garment_pattern_estimation_torch.models import build_model
from garment_pattern_estimation_torch.train import Trainer
from garment_pattern_estimation_torch.utils import tracing
from garment_pattern_estimation_tpu import experiment as jx_experiment
from garment_pattern_estimation_tpu.cli import att_weights_viz as jx_viz
from garment_pattern_estimation_tpu.cli import utility_scripts as jx_utils
from garment_pattern_estimation_tpu.train.trainer import Trainer as JaxTrainer

torch.set_num_threads(1)

FOLDERS = ['tee_synth_300', 'skirt_synth_300', 'jumpsuit_synth_300']
SPLIT = {'valid_per_type': 1, 'test_per_type': 1, 'type': 'count', 'random_seed': 10}
NN = {'panel_encoding_size': 16, 'panel_hidden_size': 16, 'panel_n_layers': 1,
      'EConv_hidden': 10, 'EConv_feature': 8, 'k_neighbors': 4, 'conv_depth': 1,
      'skip_connections': True, 'local_attention': True, 'lstm_init': 'zeros'}
LOSS = {'loss_components': ['shape', 'loop'], 'quality_components': ['shape'],
        'panel_order_inariant_loss': False, 'panel_origin_invariant_loss': False}
SETUP = {'batch_size': 4, 'epochs': 2, 'random_seed': 3, 'learning_rate': 2e-3,
         'optimizer': 'Adam', 'lr_scheduling': {'mode': '1cyclic'},
         'early_stopping': {'window': 1e-8, 'patience': 50}}
STEP_SPANS = ('gpe.train_step', 'gpe.forward', 'gpe.loss', 'gpe.backward', 'gpe.optimizer')


@pytest.mark.parametrize('window,trace', [
    ({'start_step': 1, 'num_steps': 1}, 'steps_1-2.pt.trace.json'),
    # still open when fit ends: stopped and written there
    ({'start_step': 3, 'num_steps': 10}, 'steps_3-13.pt.trace.json'),
])
def test_profiler_window_writes_a_trace(synthetic_dataset_root, tmp_path, window, trace):
    """A 2-epoch fit (2 steps each) with `trainer.profile` writes one Chrome
    trace under <run>/profile/ that parses as JSON and holds the window's
    steps, with the port's spans of each step; the spans recorded in fit
    are those of the window's one step, the profiler's alone switching
    them on; the JAX trainer makes its profile directory under the same
    config and step count."""
    root = synthetic_dataset_root
    dataset = pt_data.Garment3DPatternFullDataset(
        root, {'data_folders': FOLDERS, 'mesh_samples': 60,
               'panel_classification': str(root / 'panel_classes.json')},
        gt_caching=True, feature_caching=True)
    exp = pt_experiment.ExperimentWrappper(
        {'experiment': {'project_name': 'profile', 'run_name': 'port'}}, output_root=tmp_path)
    trainer = Trainer(dict(SETUP, profile=window), exp, dataset, dict(SPLIT), device='cpu')
    trainer.init_randomizer()
    model = build_model('GarmentSegmentPattern3D', dataset.config, NN, LOSS, device='cpu')
    trainer.fit(model)
    assert trainer.step_count == 4 and trainer._profiler is None
    files = sorted(p.name for p in (exp.run_dir() / 'profile').iterdir())
    assert files == [trace]
    events = json.loads((exp.run_dir() / 'profile' / trace).read_text())['traceEvents']
    assert any(e.get('name', '').startswith('aten::') for e in events)
    assert set(STEP_SPANS) <= {e.get('name') for e in events}
    assert [s.name for s in tracing.take()] == list(STEP_SPANS)

    jx_exp = jx_experiment.ExperimentWrappper(
        {'experiment': {'project_name': 'profile', 'run_name': 'jax'}}, output_root=tmp_path)
    jx_exp.init_run({})
    jax_trainer = JaxTrainer.__new__(JaxTrainer)
    jax_trainer.setup, jax_trainer.experiment = dict(SETUP, profile=window), jx_exp
    for step in range(trainer.step_count):
        jax_trainer._maybe_profile(step)
    if getattr(jax_trainer, '_profiling', False):
        # the JAX trainer leaves a window open at the end of fit
        import jax
        jax.profiler.stop_trace()
    assert any((jx_exp.run_dir() / 'profile').rglob('*'))


@pytest.fixture()
def prediction_dir(tmp_path):
    """A prediction folder as save_prediction_batch writes it: a point cloud
    and its attention weights over 6 panels."""
    rng = np.random.default_rng(5)
    folder = tmp_path / 'pred' / 'tee_00000'
    folder.mkdir(parents=True)
    np.savetxt(folder / 'tee_00000_point_cloud.txt', rng.normal(size=(300, 3)) * 20)
    weights = rng.random((300, 6))
    np.savetxt(folder / 'tee_00000_att_weights.txt', weights / weights.sum(1, keepdims=True))
    return folder


def test_att_weights_viz_matches_jax(prediction_dir, tmp_path):
    pytest.importorskip('matplotlib')
    ours = pt_viz.main(['-d', str(prediction_dir), '--out', str(tmp_path / 'port.png')])
    theirs = jx_viz.main(['-d', str(prediction_dir), '--out', str(tmp_path / 'jax.png')])
    if ours.read_bytes() != theirs.read_bytes():
        import matplotlib.image
        np.testing.assert_array_equal(matplotlib.image.imread(ours),
                                      matplotlib.image.imread(theirs))
    default = pt_viz.main(['-d', str(prediction_dir)])
    assert default == prediction_dir / 'tee_00000_point_cloud_att_viz.png' and default.exists()
    with pytest.raises(FileNotFoundError, match='att_weights'):
        pt_viz.main(['-d', str(tmp_path)])


def test_att_weights_viz_without_matplotlib_raises(prediction_dir, tmp_path, monkeypatch):
    """Importing the CLI needs no matplotlib; drawing without it raises
    ImportError in both packages."""
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split('.')[0] == 'matplotlib':
            raise ImportError('no matplotlib')
        return real_import(name, *args, **kwargs)
    monkeypatch.setattr(builtins, '__import__', no_matplotlib)
    for viz in (pt_viz, jx_viz):
        with pytest.raises(ImportError):
            viz.main(['-d', str(prediction_dir), '--out', str(tmp_path / 'x.png')])


def test_param_filter_matches_jax(synthetic_dataset_root, tmp_path):
    filter_file = tmp_path / 'param_filter.json'
    filter_file.write_text(json.dumps({'tee_synth': {'scale': [0.9, 1.1]},
                                       'skirt_synth': {'scale': [1.0, 1.2]}}))
    ours = pt_utils.main(['param_filter', '--data_root', str(synthetic_dataset_root),
                          '--filter', str(filter_file)])
    theirs = jx_utils.main(['param_filter', '--data_root', str(synthetic_dataset_root),
                            '--filter', str(filter_file)])
    assert ours == theirs
    assert set(ours) == set(FOLDERS) and all(total == 6 for _, total in ours.values())
    assert ours['jumpsuit_synth_300'] == (6, 6)
    assert ours['tee_synth_300'][0] < 6 or ours['skirt_synth_300'][0] < 6


def test_sampling_check_matches_jax(synthetic_dataset_root):
    obj = sorted((synthetic_dataset_root / 'tee_synth_300').glob('*/*_sim.obj'))[0]
    ours = pt_utils.main(['sampling_check', '--obj', str(obj), '--num_points', '500'])
    theirs = jx_utils.main(['sampling_check', '--obj', str(obj), '--num_points', '500'])
    assert ours.shape == (500, 3)
    np.testing.assert_array_equal(ours, theirs)


def test_pack_unpack_round_trip(synthetic_dataset_root, tmp_path):
    """A packed data folder unpacks to the same files, byte for byte, and
    the JAX package's unpack reads the port's archive the same way."""
    archive = pt_utils.main(['pack', '--data_root', str(synthetic_dataset_root),
                             '--folder', 'skirt_synth_300', '--out', str(tmp_path / 'art')])
    assert archive == tmp_path / 'art' / 'skirt_synth_300.tar.gz'
    pt_utils.main(['unpack', '--archive', str(archive), '--data_root', str(tmp_path / 'pt')])
    jx_utils.main(['unpack', '--archive', str(archive), '--data_root', str(tmp_path / 'jx')])
    source = synthetic_dataset_root / 'skirt_synth_300'
    files = sorted(p.relative_to(source) for p in source.rglob('*') if p.is_file())
    assert files
    for target in (tmp_path / 'pt' / 'skirt_synth_300', tmp_path / 'jx' / 'skirt_synth_300'):
        assert sorted(p.relative_to(target) for p in target.rglob('*') if p.is_file()) == files
        for rel in files:
            assert filecmp.cmp(source / rel, target / rel, shallow=False), rel
