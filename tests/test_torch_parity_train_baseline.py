"""`--torch_train_cross_check` of the port's parity CLI
(garment_pattern_estimation_torch/cli/parity_check.py) against the JAX
CLI's on the baseline `GarmentFullPattern3D` with the stitch-tag and
free-class terms joining at `epoch_with_stitches` (2 of 4 epochs), on
tests/test_parity_check.py's synthetic data, on the CPU, `--noise_floor
--noise_seeds 1`; the JAX CLI runs once, in a module fixture.

Bars, with the gaps measured here:
  * the replica columns (`torch_trained_metrics`, `torch_noise_seed_metrics`,
    the `torch` halves of the losses) within rtol 1e-6 of the JAX CLI's,
    `torch_noise_floor` within 1e-6 absolute (measured: at most 7.5e-8
    relative; floors 9.4e-8 absolute);
  * the port arm's first-step loss within rtol 1e-4 of the JAX arm's
    (measured: 1.8e-7 relative);
  * its converged metrics, the stitch precision and recall and free-edge
    accuracy among them, within max(1%, the JAX report's
    `torch_noise_floor[key]`) of the JAX arm's (measured: at most 4.4e-5
    relative; stitch precision and recall are 0 on both sides at this
    size).
"""
import json

import pytest
import yaml

from garment_pattern_estimation_torch.cli import parity_check as pt_parity
from test_parity_check import parity_env  # noqa: F401  (the shared fixture)

REPLICA_RTOL = 1e-6
FLOOR_ABS = 1e-6
FIRST_STEP_RTOL = 1e-4
METRIC_BAR = 0.01
STITCH_KEYS = ('stitch_precision', 'stitch_recall', 'free_edge_acc')


@pytest.fixture(scope='module')
def reports(parity_env, tmp_path_factory):  # noqa: F811
    from garment_pattern_estimation_tpu.cli import parity_check as jx_parity

    _, data, _, _, _, _ = parity_env
    work = tmp_path_factory.mktemp('baseline_train')
    config = {
        'experiment': {'project_name': 'Parity', 'run_name': 'lstm-ab', 'run_id': None},
        'dataset': {'class': 'Garment3DPatternFullDataset',
                    'data_folders': ['tee_synth_300', 'skirt_synth_300', 'jumpsuit_synth_300'],
                    'mesh_samples': 60, 'obj_filetag': 'sim', 'point_noise_w': 0,
                    'panel_classification': str(data / 'panel_classes.json')},
        'data_split': {'valid_per_type': 1, 'test_per_type': 2, 'random_seed': 10,
                       'type': 'count'},
        'NN': {'model': 'GarmentFullPattern3D', 'feature_extractor': 'EdgeConvFeatures',
               'conv_depth': 1, 'k_neighbors': 5, 'EConv_hidden': 12, 'EConv_feature': 10,
               'EConv_hidden_depth': 1, 'EConv_aggr': 'max', 'global_pool': 'mean',
               'skip_connections': True, 'panel_decoder': 'LSTMDecoderModule',
               'panel_encoding_size': 16, 'panel_hidden_size': 16, 'panel_n_layers': 1,
               'pattern_decoder': 'LSTMDecoderModule', 'pattern_encoding_size': 16,
               'pattern_hidden_size': 16, 'pattern_n_layers': 1, 'stitch_tag_dim': 3,
               'loss': {'loss_components': ['shape', 'loop', 'rotation', 'translation',
                                            'stitch', 'free_class'],
                        'quality_components': ['shape', 'discrete', 'rotation',
                                               'translation', 'stitch', 'free_class'],
                        'epoch_with_stitches': 2, 'stitch_tags_margin': 0.3,
                        'panel_origin_invariant_loss': False,
                        'panel_order_inariant_loss': False}},
        'trainer': {'batch_size': 4, 'epochs': 1, 'random_seed': 1, 'learning_rate': 0.002,
                    'optimizer': 'Adam', 'lr_scheduling': {'mode': '1cyclic'}},
    }
    (work / 'lstm_ab.yaml').write_text(yaml.safe_dump(config, sort_keys=False))
    args = ['--dataset_root', str(data), '--shape_config', str(work / 'lstm_ab.yaml'),
            '--torch_train_cross_check', '--train_epochs', '4', '--tolerance', '0.9',
            '--noise_floor', '--noise_seeds', '1']
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        for name, main, extra in (('jax', jx_parity.main, []),
                                  ('port', pt_parity.main, ['--device', 'cpu'])):
            assert main(args + extra + ['--output', str(work / f'{name}.json')]) == 0
            out[name] = json.loads((work / f'{name}.json').read_text())
    return out


def test_baseline_replica_columns_equal_the_jax_clis(reports):
    jax, port = reports['jax'], reports['port']
    assert set(port) == {k.replace('_jax_', '_port_') for k in jax}
    assert set(STITCH_KEYS) <= set(jax['torch_trained_metrics'])
    for section in ('torch_trained_metrics', 'torch_noise_seed_metrics'):
        theirs = jax[section] if isinstance(jax[section], list) else [jax[section]]
        ours = port[section] if isinstance(port[section], list) else [port[section]]
        for a, b in zip(ours, theirs):
            assert set(a) == set(b), section
            for key, value in b.items():
                assert a[key] == pytest.approx(value, rel=REPLICA_RTOL, abs=1e-12), key
    for key, value in jax['torch_noise_floor'].items():
        assert port['torch_noise_floor'][key] == pytest.approx(value, rel=0, abs=FLOOR_ABS)
    for key in ('train_loss_first_step', 'train_loss_last_epoch'):
        assert port[key]['torch'] == pytest.approx(jax[key]['torch'], rel=REPLICA_RTOL)


def test_baseline_port_arm_matches_the_jax_arm(reports):
    jax, port = reports['jax'], reports['port']
    assert port['train_loss_first_step']['ours'] == pytest.approx(
        jax['train_loss_first_step']['ours'], rel=FIRST_STEP_RTOL)
    assert set(port['trained_shape_metrics']) == set(jax['trained_shape_metrics'])
    assert set(STITCH_KEYS) <= set(port['trained_shape_metrics'])
    for key, value in jax['trained_shape_metrics'].items():
        bar = max(METRIC_BAR, jax['torch_noise_floor'].get(key, 0.0))
        assert abs(port['trained_shape_metrics'][key] - value) <= bar * max(abs(value), 1e-3), key
