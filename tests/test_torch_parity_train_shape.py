"""`--torch_train_cross_check` of the port's parity CLI
(garment_pattern_estimation_torch/cli/parity_check.py) against the JAX
CLI's, on tests/test_parity_check.py's fixture (synthetic data, a tiny
attention model), both on the CPU: `--train_epochs 3 --noise_floor
--noise_seeds 2` and one extra framework seed (`--jax_seeds 1` there,
`--port_seeds 1` here), each CLI run once in a module fixture.

Bars, with the gaps measured on this fixture:
  * the replica columns (`torch_trained_metrics`, `torch_noise_seed_metrics`,
    the `torch` halves of `train_loss_first_step` and
    `train_loss_last_epoch`) equal the JAX CLI's within rtol 1e-6: the same
    replica code, init and batches on the CPU (measured: the losses equal,
    the metrics at most 6.8e-8 relative apart, one f32 rounding: the
    replica's predictions go through the port's metric code here and the
    JAX package's there);
  * `torch_noise_floor`, a relative spread (dimensionless), within 1e-6
    absolute: a metric's rounding gap over the base metric (measured:
    7.3e-8 absolute, which is 1.1e-6 of that floor's 0.065);
  * the port arm's first-step loss within rtol 1e-4 of the JAX arm's:
    the same init and batch, PARITY.md's bar (measured: 1.3e-7 relative);
  * the port's converged metrics within max(1%, the JAX report's
    `torch_noise_floor[key]`) of the JAX arm's (measured: at most 5.3e-5
    relative, rotation_l2);
  * `port_seed_metrics` and `paired_cross_framework_deltas` with the keys
    of the JAX CLI's `jax_seed_metrics` and deltas;
  * `--torch_from_report` on the JAX CLI's report trains no replica and
    copies its replica columns exactly.
"""
import json

import pytest

from garment_pattern_estimation_torch.cli import parity_check as pt_parity
from test_parity_check import parity_env  # noqa: F401  (the shared fixture)

REPLICA_RTOL = 1e-6
FLOOR_ABS = 1e-6
FIRST_STEP_RTOL = 1e-4
METRIC_BAR = 0.01
TRAIN_ARGS = ['--torch_train_cross_check', '--train_epochs', '3', '--tolerance', '0.5',
              '--noise_floor', '--noise_seeds', '2']


@pytest.fixture(scope='module')
def reports(parity_env, tmp_path_factory):  # noqa: F811
    """The JAX CLI's and the port's (CPU) reports of one campaign."""
    from garment_pattern_estimation_tpu.cli import parity_check as jx_parity

    _, data, shape_yaml, _, _, _ = parity_env
    base = ['--dataset_root', str(data), '--shape_config', str(shape_yaml)] + TRAIN_ARGS
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, main, extra in (('jax', jx_parity.main, ['--jax_seeds', '1']),
                                  ('port', pt_parity.main,
                                   ['--port_seeds', '1', '--device', 'cpu'])):
            work = tmp_path_factory.mktemp(f'train_{name}')
            mp.chdir(work)
            assert main(base + extra + ['--output', str(work / 'report.json')]) == 0
            out[name] = json.loads((work / 'report.json').read_text())
    return parity_env, base, out


def _close(a, b, rtol):
    return a == pytest.approx(b, rel=rtol, abs=1e-12)


def test_replica_columns_equal_the_jax_clis(reports):
    _, _, out = reports
    jax, port = out['jax'], out['port']
    assert set(port['torch_trained_metrics']) == set(jax['torch_trained_metrics'])
    for metric, value in jax['torch_trained_metrics'].items():
        assert _close(port['torch_trained_metrics'][metric], value, REPLICA_RTOL), metric
    assert set(port['torch_noise_floor']) == set(jax['torch_noise_floor'])
    for metric, value in jax['torch_noise_floor'].items():
        assert port['torch_noise_floor'][metric] == pytest.approx(value, rel=0, abs=FLOOR_ABS)
    assert len(port['torch_noise_seed_metrics']) == len(jax['torch_noise_seed_metrics']) == 2
    for ours, theirs in zip(port['torch_noise_seed_metrics'], jax['torch_noise_seed_metrics']):
        assert set(ours) == set(theirs)
        assert all(_close(ours[k], v, REPLICA_RTOL) for k, v in theirs.items())
    for key in ('train_loss_first_step', 'train_loss_last_epoch'):
        assert _close(port[key]['torch'], jax[key]['torch'], REPLICA_RTOL), key


def test_port_arm_matches_the_jax_arm(reports):
    """The first-step loss within 1e-4 relative; the converged test metrics
    within max(1%, the replica's seed-to-seed floor)."""
    _, _, out = reports
    jax, port = out['jax'], out['port']
    assert _close(port['train_loss_first_step']['ours'], jax['train_loss_first_step']['ours'],
                  FIRST_STEP_RTOL)
    assert set(port['trained_shape_metrics']) == set(jax['trained_shape_metrics']) \
        == set(pt_parity.SHAPE_METRICS)
    for key, value in jax['trained_shape_metrics'].items():
        bar = max(METRIC_BAR, jax['torch_noise_floor'].get(key, 0.0))
        assert abs(port['trained_shape_metrics'][key] - value) <= bar * max(abs(value), 1e-3), key


def test_report_keys_map_to_the_jax_clis(reports):
    """The same keys, `jax` named `port`; the extra seed's metrics and the
    paired deltas have the JAX CLI's structure; the rows and bars too."""
    _, _, out = reports
    jax, port = out['jax'], out['port']

    def mapped(key):
        return key.replace('_jax_', '_port_').replace('jax_', 'port_')

    assert set(port) == {mapped(k) for k in jax}
    assert [set(m) for m in port['port_seed_metrics']] \
        == [set(m) for m in jax['jax_seed_metrics']]
    paired_port, paired_jax = port['paired_cross_framework_deltas'], \
        jax['paired_cross_framework_deltas']
    assert set(paired_port) == set(paired_jax)
    for key, entry in paired_jax.items():
        assert set(paired_port[key]) == set(entry)
        assert len(paired_port[key]['per_seed_signed']) == len(entry['per_seed_signed']) == 2
    assert [c['metric'] for c in port['comparisons']] == [c['metric'] for c in jax['comparisons']]
    for ours, theirs in zip(port['comparisons'], jax['comparisons']):
        assert _close(ours['reference'], theirs['reference'], REPLICA_RTOL)
        assert ours['bar'] == pytest.approx(theirs['bar'], rel=REPLICA_RTOL)


def test_torch_from_report_reuses_the_jax_columns(reports, tmp_path, monkeypatch, capsys):
    _, base, out = reports
    monkeypatch.chdir(tmp_path)
    (tmp_path / 'jax.json').write_text(json.dumps(out['jax']))
    capsys.readouterr()
    assert pt_parity.main(base + ['--device', 'cpu', '--torch_from_report',
                                  str(tmp_path / 'jax.json'),
                                  '--output', str(tmp_path / 'reused.json')]) == 0
    printed = capsys.readouterr().out
    assert 'training the torch reference recipe' not in printed
    assert 'noise floor' not in printed
    reused = json.loads((tmp_path / 'reused.json').read_text())
    assert reused['torch_columns_reused_from'].endswith('jax.json')
    for key in ('torch_trained_metrics', 'torch_noise_seed_metrics', 'torch_noise_floor'):
        assert reused[key] == out['jax'][key], key
    for key in ('train_loss_first_step', 'train_loss_last_epoch'):
        assert reused[key]['torch'] == out['jax'][key]['torch']
        assert reused[key]['ours'] == out['port'][key]['ours']
    assert reused['trained_shape_metrics'] == out['port']['trained_shape_metrics']
