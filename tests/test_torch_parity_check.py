"""The port's parity CLI (garment_pattern_estimation_torch/cli/parity_check.py)
against the JAX package's, on tests/test_parity_check.py's fixture:
synthetic data and reference-format `.pth` checkpoints from the JAX
package's `randomize_reference_weights`, a tiny attention shape model and a
stitch model.

Both CLIs evaluate the same checkpoints on the same test split: the shape
and stitch metrics agree within METRIC_RTOL = 1e-3 relative (metrics that
are 0 within 1e-6), tests/test_torch_evaluation.py's bar for the same
metrics (the JAX side's kernels and the port's plain versions round the
distances and sums differently: rotation_l2 moves by about 1e-4 of itself
here), and the reports carry the same keys. The port's
`--jax_report` on the JAX report passes every row; `--expected` passes at
1.005 times the port's own metrics and fails, with exit code 1, at 1.10
times; every replica-mode flag of the JAX CLI has its counterpart here,
which parses (tests/test_torch_parity_train*.py run the modes).
"""
import json

import pytest

from garment_pattern_estimation_torch.cli import parity_check as pt_parity
from test_parity_check import parity_env  # noqa: F401  (the shared fixture)

METRIC_RTOL = 1e-3


def _args(env, output, stitch=True):
    _, data, shape_yaml, shape_pth, stitch_yaml, stitch_pth = env
    args = ['--dataset_root', str(data), '--shape_config', str(shape_yaml),
            '--shape_pth', str(shape_pth), '--output', str(output)]
    if stitch:
        args += ['--stitch_config', str(stitch_yaml), '--stitch_pth', str(stitch_pth)]
    return args


@pytest.fixture(scope='module')
def reports(parity_env, tmp_path_factory):  # noqa: F811
    """The JAX CLI's and the port's (CPU) reports, two-stage, each run in a
    directory of its own (the predictions land under the working
    directory)."""
    from garment_pattern_estimation_tpu.cli import parity_check as jx_parity

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, main, extra in (('jax', jx_parity.main, []),
                                  ('port', pt_parity.main, ['--device', 'cpu'])):
            work = tmp_path_factory.mktemp(f'parity_{name}')
            mp.chdir(work)
            assert main(_args(parity_env, work / 'report.json') + extra) == 0
            out[name] = work / 'report.json'
    return parity_env, out


def _close(a, b):
    return a == pytest.approx(b, rel=METRIC_RTOL, abs=1e-6)


def test_port_metrics_match_the_jax_cli(reports):
    _, paths = reports
    jax, port = (json.loads(paths[n].read_text()) for n in ('jax', 'port'))
    assert set(port) == set(jax)
    for section in ('shape_metrics', 'stitch_metrics'):
        assert set(port[section]) == set(jax[section]), section
        for key, value in jax[section].items():
            assert _close(port[section][key], value), (section, key, port[section][key], value)
    assert set(port['shape_metrics']) == set(pt_parity.SHAPE_METRICS)
    assert 'stitch_f1' in port['stitch_metrics']


def test_jax_report_mode_passes_every_row(reports, tmp_path, monkeypatch):
    env, paths = reports
    monkeypatch.chdir(tmp_path)
    rc = pt_parity.main(_args(env, tmp_path / 'vs_jax.json')
                        + ['--jax_report', str(paths['jax']), '--device', 'cpu'])
    assert rc == 0
    report = json.loads((tmp_path / 'vs_jax.json').read_text())
    jax = json.loads(paths['jax'].read_text())
    rows = {c['metric']: c for c in report['comparisons']}
    assert set(rows) == {f'jax:{k}' for k in (*jax['shape_metrics'], *jax['stitch_metrics'])}
    assert all(c['pass'] and c['bar'] == 0.01 for c in rows.values())


@pytest.mark.parametrize('factor,rc', [(1.005, 0), (1.10, 1)])
def test_expected_passes_and_fails(reports, tmp_path, monkeypatch, factor, rc):
    """Published numbers 0.5% off the port's own pass the 1% bar, 10% off
    fail it: exit code 1 and a failed row."""
    env, paths = reports
    monkeypatch.chdir(tmp_path)
    ours = json.loads(paths['port'].read_text())['shape_metrics']
    expected = dict(ours, panel_shape_l2=ours['panel_shape_l2'] * factor)
    (tmp_path / 'expected.json').write_text(json.dumps(expected))
    assert pt_parity.main(_args(env, tmp_path / 'out.json', stitch=False)
                          + ['--expected', str(tmp_path / 'expected.json'),
                             '--device', 'cpu']) == rc
    report = json.loads((tmp_path / 'out.json').read_text())
    assert report['expected'] == expected
    assert {c['metric'] for c in report['comparisons']} == {f'published:{k}' for k in expected}
    failed = [c['metric'] for c in report['comparisons'] if not c['pass']]
    assert failed == ([] if rc == 0 else ['published:panel_shape_l2'])


# the JAX CLI's modes that train or replay its torch reference replica, and
# their values where they take one
REPLICA_FLAGS = {'--torch_cross_check': None, '--torch_train_cross_check': None,
                 '--stitch_train_cross_check': None, '--train_epochs': '3',
                 '--train_seed': '2', '--noise_floor': None, '--noise_seeds': '2',
                 '--jax_seeds': '1', '--resume': None, '--stop_after_jax': None,
                 '--torch_from_report': 'r.json'}
# the flags that name the JAX CLI's framework arm name the port's here
PORT_FLAG = {'--jax_seeds': '--port_seeds', '--stop_after_jax': '--stop_after_port'}


@pytest.mark.parametrize('flag', sorted(REPLICA_FLAGS))
def test_replica_flags_have_port_counterparts(flag):
    """Each replica flag of the JAX CLI exists there, and its counterpart
    (the same name, or `port` for `jax`) parses here to what the JAX CLI
    parses it to."""
    import inspect

    from garment_pattern_estimation_tpu.cli import parity_check as jx_parity

    assert f"'{flag}'" in inspect.getsource(jx_parity.get_args)
    value = [] if REPLICA_FLAGS[flag] is None else [REPLICA_FLAGS[flag]]
    ours = PORT_FLAG.get(flag, flag)
    base = ['--dataset_root', 'd', '--shape_pth', 'p.pth']
    theirs = vars(jx_parity.get_args(base + [flag] + value))
    parsed = vars(pt_parity.get_args(base + [ours] + value))
    dest = flag[2:].replace('-', '_')
    assert parsed[ours[2:]] == theirs[dest] != jx_parity.get_args(base).__dict__[dest]
    assert pt_parity.get_args(base).__dict__[ours[2:]] == jx_parity.get_args(base).__dict__[dest]


def test_compare_rows_matches_the_jax_cli():
    """The same rows as the JAX CLI's _compare_rows, the 1e-3 floor on the
    denominator included (an accuracy at 0), and the same extra tolerance
    from `floors` (absent keys 0)."""
    from garment_pattern_estimation_tpu.cli import parity_check as jx_parity

    ours = {'a': 0.5, 'b': 1e-4, 'c': 2.0, 'd': None}
    other = {'a': 0.51, 'b': 0.0, 'c': -3.0, 'd': 1.0, 'e': 1.0}
    keys = ['a', 'b', 'c', 'd', 'e']
    for floors in (None, {'a': 0.05, 'c': 0.2}):
        rows = pt_parity._compare_rows(ours, other, keys, 'x', floors=floors)
        assert rows == jx_parity._compare_rows(ours, other, keys, 'x', floors=floors)
        assert [len(row) for row in rows] == [5, 5, 5]
    assert pt_parity._compare_rows(ours, other, keys, 'x')[1][3] == pytest.approx(0.1)
    assert [row[4] for row in pt_parity._compare_rows(ours, other, keys, 'x',
                                                      floors={'a': 0.05, 'c': 0.2})] \
        == [0.05, 0.0, 0.2]
