"""The ReLU and max choices of chip_smoke.py's step check (`StepChoices`).

chip_smoke.py holds a training step on the card against the same step on
the CPU from the same weights (`compare_step_cpu`), the CPU step taking the
card step's discrete choices: kNN ids, pooled clusters and, for the
encoder variants (`kinks`), which inputs each `torch.relu` passes and which
entries win each `torch.amax`. pool10's encoder (EdgeConvPoolingFeatures
at k = 10, its last stage 20 points) routes each channel of its global max
pool through one entry; when that entry's ReLU input sits within rounding
of 0, another rounding of the step (here: its BatchNorm moments in f64, as
the card's sums run in another order) puts the gradient a percent away.
The card's step failed the 1e-2 gradient bar so.

  * with the card's ReLU and max choices the CPU step follows another
    rounding of pool10's step to within a fifth of the 1e-2 bar, where
    without them it lands past the bar (seeds 4 and 13 of 24 at one
    thread: 5.28e-2 and 3.24e-2, against 1.31e-3 and 1.38e-4 replayed);
  * the replay refuses a recorded ReLU side or max winner that is off the
    CPU's own by more than a tie (KINK_TIE_REL), and a call sequence
    other than the recorded one.
"""
import pytest
import torch

import chip_smoke
from garment_pattern_estimation_torch.models import build_model
from garment_pattern_estimation_torch.train import Trainer

torch.set_num_threads(1)

NN = dict(chip_smoke.LSTM_NN_CONFIG, **chip_smoke.ENCODER_VARIANTS['pool10'])


def trained_step(seed, points=None, steps=3):
    """pool10's model at chip_smoke's widths after `steps` Adam steps on 4
    seeded clouds, and its 2-cloud step batch."""
    model = build_model(chip_smoke.LSTM_MODEL, chip_smoke.ATT_DATA_CONFIG, NN,
                        chip_smoke.LSTM_LOSS_CONFIG, seed=seed, device='cpu')
    batch = chip_smoke.training_batch(torch.Generator().manual_seed(100 + seed), 4, 'cpu',
                                      points=points, stitched=True)
    trainer = Trainer(chip_smoke.ATT_TRAINER, device='cpu')
    trainer.make_optimizer(model, steps_per_epoch=steps)
    states = torch.Generator().manual_seed(1)
    for _ in range(steps):
        trainer.train_step(model, batch, epoch=0, generator=states)
    return model, {'features': batch['features'][:2],
                   'ground_truth': {k: v[:2] for k, v in batch['ground_truth'].items()}}


def replayed_gap(model, batch, kinks):
    """The gradient gap of the plain f32 step, replaying the choices of the
    step with f64 BatchNorm moments, to that step; and the replay's kink
    counts."""
    choices = chip_smoke.StepChoices(model.module, kinks)
    with choices.record(), chip_smoke._moments64(True):
        _, other = chip_smoke.step_gradients(model, batch)
    with choices.replay():
        _, grads = chip_smoke.step_gradients(model, batch)
    return chip_smoke.gradient_gap(grads, other)['grad_rel_l2'], getattr(
        choices, 'kink_lines', None)


@pytest.mark.parametrize('seed', [4, 13])
def test_kinks_hold_the_step_to_another_rounding(seed):
    model, batch = trained_step(seed)
    loose, _ = replayed_gap(model, batch, kinks=False)
    held, lines = replayed_gap(model, batch, kinks=True)
    assert loose > chip_smoke.TRAIN_GRAD_REL, loose
    assert held < chip_smoke.TRAIN_GRAD_REL / 5, (held, lines)
    assert lines['relu']['calls'] == 9 and lines['max']['calls'] == 6, lines
    assert lines['relu']['differ'] >= 1, lines
    assert max(line['worst_rel'] for line in lines.values()) < chip_smoke.KINK_TIE_REL / 100


@pytest.fixture(scope='module')
def small():
    return trained_step(0, points=200, steps=1)


def recorded(model, batch):
    choices = chip_smoke.StepChoices(model.module, kinks=True)
    with choices.record():
        chip_smoke.step_gradients(model, batch)
    return choices


@pytest.mark.parametrize('kind', ['relu', 'max'])
def test_replay_refuses_a_choice_off_a_tie(small, kind, capsys):
    model, batch = small
    choices = recorded(model, batch)
    at = next(i for i, (k, _, mask) in enumerate(choices.kinks) if k == kind)
    kind, shape, mask = choices.kinks[at]
    choices.kinks[at] = (kind, shape, ~mask)      # every side flipped, every loser wins
    with pytest.raises(SystemExit):
        with choices.replay():
            chip_smoke.step_gradients(model, batch)
    assert f'a {kind} choice of the card is off' in capsys.readouterr().err


def test_replay_takes_each_choice_once(small, capsys):
    model, batch = small
    choices = recorded(model, batch)
    with choices.replay():
        chip_smoke.step_gradients(model, batch)
    choices.kinks.pop()
    with pytest.raises(SystemExit):
        with choices.replay():
            chip_smoke.step_gradients(model, batch)
    assert 'where the card made no more' in capsys.readouterr().err
