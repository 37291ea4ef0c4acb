"""A run driven on the CPU at a small size, past the look for a card: sound,
`correct` comes out true; with the timed path broken underneath (a step
that returns its state unchanged, half of the batch left out, an answer
altered where it is produced) and with the control in the program's
place, false, under each cell's own limits."""
import copy

import pytest
import torch

from benchmark import common
from benchmark.entries import entry_class
from benchmark.reference import compare
from benchmark.run import run_cell

SMALL = {'train': {'batch': 4, 'points': 256, 'pool_batches': 4, 'warmup_steps': 4,
                   'trace_seconds': 0.2, 'trace_max_iterations': 2},
         'serve': {'batch': 3, 'points': 256, 'pool_batches': 3, 'check_clouds': 8,
                   'trace_seconds': 0.2, 'trace_max_iterations': 2}}
SEED = 2 ** 31 + 12345


def small_cell(name):
    cell = common.cell(name)
    cell['traffic'].update(SMALL[cell['traffic']['entry']])
    return cell


def run(name, trace=False):
    return run_cell(name, SEED, 0.5, trace, device='cpu', cell=small_cell(name))


@pytest.fixture
def unchanged_state(monkeypatch):
    from garment_pattern_estimation_torch.train.trainer import Trainer
    step = Trainer.train_step

    def frozen(self, model, *args, **kwargs):
        before = copy.deepcopy(model.module.state_dict())
        out = step(self, model, *args, **kwargs)
        model.module.load_state_dict(before)
        return out
    monkeypatch.setattr(Trainer, 'train_step', frozen)


@pytest.fixture
def half_batch_train(monkeypatch):
    from garment_pattern_estimation_torch.train.trainer import Trainer
    step = Trainer.train_step

    def half(self, model, batch, *args, **kwargs):
        n = batch['features'].shape[0] // 2
        cut = {'features': batch['features'][:n],
               'ground_truth': {k: v[:n] for k, v in batch['ground_truth'].items()}}
        return step(self, model, cut, *args, **kwargs)
    monkeypatch.setattr(Trainer, 'train_step', half)


def broken_serving(monkeypatch, alter):
    import garment_pattern_estimation_torch.experiment as experiment
    build = experiment.build_serving_fn

    def patched(model, data_config):
        serve = build(model, data_config)
        return lambda points: alter(serve, points)
    monkeypatch.setattr(experiment, 'build_serving_fn', patched)


def half_batch(serve, points):
    """Serve the first half; the rest gets the first half's answers."""
    n = (points.shape[0] + 1) // 2
    out = serve(points[:n])
    return {k: torch.cat([v, v])[:points.shape[0]] for k, v in out.items()}


def altered(serve, points):
    out = serve(points)
    out['outlines'] = out['outlines'].clone()
    out['outlines'][:, 0, 0, 0] += 1.0
    return out


TRAIN, SERVE = 'att-train-n2000', 'baseline-serve-n2000'


def test_sound_runs_are_correct():
    for name in (TRAIN, SERVE):
        result = run(name)
        assert result['correct'], result['checks']
        assert list(result)[-1] == 'checks'
        e2e, _ = common.metrics_of(name)
        assert set(result['metrics']) == {m['name'] for m in e2e}


def test_traced_run_reports_its_per_layer_metrics_on_the_cpu():
    result = run(SERVE, trace=True)
    assert result['correct'] and 'breakdown' in result
    assert 'serve_mfu.n2000' in result['metrics']


def test_state_unchanged_is_caught(unchanged_state):
    result = run(TRAIN)
    assert not result['correct']
    assert result['checks']['change']['value'] == pytest.approx(1.0)


def test_half_batch_is_caught_in_training(half_batch_train):
    assert not run(TRAIN)['correct']


def test_half_batch_is_caught_in_serving(monkeypatch):
    broken_serving(monkeypatch, half_batch)
    assert not run(SERVE)['correct']


def test_altered_answer_is_caught(monkeypatch):
    broken_serving(monkeypatch, altered)
    assert not run(SERVE)['correct']


@pytest.mark.parametrize('name', [TRAIN, SERVE])
def test_control_fails_the_limits(name):
    cell = small_cell(name)
    entry = entry_class(cell['traffic']['entry'])(cell, 'cpu', SEED)
    entry.window(0.5)
    correct, checks = compare.judge(entry.numbers(lowered=True), cell['limits']['numbers'])
    assert not correct, checks
