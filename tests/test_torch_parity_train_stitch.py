"""`--stitch_train_cross_check` of the port's parity CLI
(garment_pattern_estimation_torch/cli/parity_check.py) against the JAX
CLI's, and `--stop_after_port` + `--resume`, on tests/test_parity_check.py's
synthetic data, on the CPU. The JAX CLI runs once, in a module fixture:
`--stitch_train_cross_check --train_epochs 3 --noise_floor --noise_seeds 1`
on the stitch pair classifier of tests/test_parity_check.py's stitch test
(16 -> 16 -> 16 -> 1, 20 + 20 pairs a garment).

Bars, with the gaps measured here:
  * the replica columns (`torch_stitch_trained_metrics`,
    `torch_stitch_noise_seed_metrics`, the `torch` half of
    `stitch_train_loss_first_step`) within rtol 1e-6 of the JAX CLI's, and
    `torch_stitch_noise_floor` within 1e-6 absolute (measured: equal);
  * the port arm's first-step loss within rtol 1e-4 of the JAX arm's
    (measured: equal, 0.85824299);
  * the port's converged stitch metrics within max(1%, the JAX report's
    `torch_stitch_noise_floor[key]`) of the JAX arm's (measured: equal). At
    this size every arm's test predictions are one class (precision 0,
    pair accuracy 0.5; the reference's batch norm after the logit), so
    these rows check the machinery, and the first-step loss the
    arithmetic;
  * a shape campaign stopped by `--stop_after_port` and then `--resume`d
    writes the report an uninterrupted run writes, and a third `--resume`
    trains nothing and writes it again.
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


@pytest.fixture(scope='module')
def reports(parity_env, tmp_path_factory):  # noqa: F811
    from garment_pattern_estimation_tpu.cli import parity_check as jx_parity

    _, data, _, _, _, _ = parity_env
    work = tmp_path_factory.mktemp('stitch_train')
    config = {
        'experiment': {'project_name': 'Parity', 'run_name': 'stitch-ab', 'run_id': None},
        'dataset': {'class': 'GarmentStitchPairsDataset',
                    'data_folders': ['tee_synth_300', 'skirt_synth_300', 'jumpsuit_synth_300'],
                    'stitched_edge_pairs_num': 20, 'non_stitched_edge_pairs_num': 20,
                    'pairs_seed': 3},
        'data_split': {'valid_per_type': 1, 'test_per_type': 2, 'random_seed': 10,
                       'type': 'count'},
        'NN': {'model': 'StitchOnEdge3DPairs', 'stitch_hidden_size': 16,
               'stitch_mlp_n_layers': 2,
               'loss': {'loss_components': ['edge_pair_class'],
                        'quality_components': ['edge_pair_class', 'edge_pair_stitch_recall']}},
        'trainer': {'batch_size': 2, 'learning_rate': 0.002},
    }
    (work / 'stitch_ab.yaml').write_text(yaml.safe_dump(config, sort_keys=False))
    args = ['--dataset_root', str(data), '--stitch_config', str(work / 'stitch_ab.yaml'),
            '--stitch_train_cross_check', '--train_epochs', '3', '--tolerance', '0.9',
            '--noise_floor', '--noise_seeds', '1']
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        for name, main, extra in (('jax', jx_parity.main, []),
                                  ('port', pt_parity.main, ['--device', 'cpu'])):
            assert main(args + extra + ['--output', str(work / f'{name}.json')]) == 0
            out[name] = json.loads((work / f'{name}.json').read_text())
    return out


def test_stitch_replica_columns_equal_the_jax_clis(reports):
    jax, port = reports['jax'], reports['port']
    assert set(port) == set(jax)
    assert set(port['torch_stitch_trained_metrics']) == set(pt_parity.STITCH_METRICS)
    for key, value in jax['torch_stitch_trained_metrics'].items():
        assert port['torch_stitch_trained_metrics'][key] == pytest.approx(
            value, rel=REPLICA_RTOL, abs=1e-12), key
    assert len(port['torch_stitch_noise_seed_metrics']) == 1
    for key, value in jax['torch_stitch_noise_seed_metrics'][0].items():
        assert port['torch_stitch_noise_seed_metrics'][0][key] == pytest.approx(
            value, rel=REPLICA_RTOL, abs=1e-12), key
    assert set(port['torch_stitch_noise_floor']) == set(jax['torch_stitch_noise_floor'])
    for key, value in jax['torch_stitch_noise_floor'].items():
        assert port['torch_stitch_noise_floor'][key] == pytest.approx(value, rel=0,
                                                                      abs=FLOOR_ABS), key
    assert port['stitch_train_loss_first_step']['torch'] == pytest.approx(
        jax['stitch_train_loss_first_step']['torch'], rel=REPLICA_RTOL)


def test_stitch_port_arm_matches_the_jax_arm(reports):
    jax, port = reports['jax'], reports['port']
    assert port['stitch_train_loss_first_step']['ours'] == pytest.approx(
        jax['stitch_train_loss_first_step']['ours'], rel=FIRST_STEP_RTOL)
    assert set(port['stitch_trained_metrics']) == set(jax['stitch_trained_metrics'])
    for key, value in jax['stitch_trained_metrics'].items():
        bar = max(METRIC_BAR, jax['torch_stitch_noise_floor'].get(key, 0.0))
        assert abs(port['stitch_trained_metrics'][key] - value) <= bar * max(abs(value), 1e-3)
    assert [c['metric'] for c in port['comparisons']] == [c['metric'] for c in jax['comparisons']]


def test_stop_after_port_then_resume_equals_one_run(parity_env, tmp_path,  # noqa: F811
                                                    monkeypatch, capsys):
    _, data, shape_yaml, _, _, _ = parity_env
    monkeypatch.chdir(tmp_path)
    args = ['--dataset_root', str(data), '--shape_config', str(shape_yaml),
            '--torch_train_cross_check', '--train_epochs', '2', '--tolerance', '0.9',
            '--port_seeds', '1', '--noise_floor', '--noise_seeds', '1', '--device', 'cpu']
    assert pt_parity.main(args + ['--output', str(tmp_path / 'whole.json')]) == 0
    whole = json.loads((tmp_path / 'whole.json').read_text())

    out = tmp_path / 'split.json'
    resumed = args + ['--resume', '--output', str(out)]
    assert pt_parity.main(resumed + ['--stop_after_port']) == 0
    first = json.loads(out.read_text())
    assert first['stopped_after_port'] is True
    assert len(first['_resume_port_seed_metrics']) == 1
    assert '_resume_torch_base_metrics' not in first and 'torch_trained_metrics' not in first
    capsys.readouterr()

    assert pt_parity.main(resumed) == 0
    printed = capsys.readouterr().out
    assert 'the port base arm reloaded' in printed and 'training port seed' not in printed
    assert json.loads(out.read_text()) == whole

    assert pt_parity.main(resumed) == 0
    printed = capsys.readouterr().out
    assert 'training' not in printed and 'evaluating' not in printed
    assert json.loads(out.read_text()) == whole
