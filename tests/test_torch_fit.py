"""The port's `Trainer.fit` against the JAX package's `Trainer.fit`.

Both sides train the attention model at tests/test_train_e2e.py's tiny
widths on one synthetic root: batch 4, Adam with the one-cycle schedule,
the same split, the same standardization and the same starting weights
(JAX's initial variables carried over with `state_dict_from_flax`). The
LSTM initial states are zeros on both sides (`lstm_init: 'zeros'`), so both
runs are deterministic; the JAX side runs its plain (`use_pallas=False`)
path. Measured on this setup: the first step's losses agree within 2e-7
relative; every later step within 1e-4 and validation losses within
2.7e-4, because Adam's first update moves each weight by about the
learning rate in the sign of its gradient, and for gradients at the level
of f32 rounding that sign is the framework's. The bars are 5e-4 (steps) and
1e-3 (validation); learning rates within 1e-6 (the same optax formula in
f32).
"""
import json

import numpy as np
import pytest
import torch

from garment_pattern_estimation_torch import data as pt_data
from garment_pattern_estimation_torch import experiment as pt_experiment
from garment_pattern_estimation_torch import train as pt_train
from garment_pattern_estimation_torch.models import build_model as pt_build_model
from garment_pattern_estimation_torch.models import blocks as pt_blocks
from garment_pattern_estimation_torch.models.flax_import import state_dict_from_flax
from garment_pattern_estimation_tpu import data as jx_data
from garment_pattern_estimation_tpu import experiment as jx_experiment
from garment_pattern_estimation_tpu import train as jx_train
from garment_pattern_estimation_tpu.models import build_model as jx_build_model

FOLDERS = ['tee_synth_300', 'skirt_synth_300', 'jumpsuit_synth_300']
NN = {'panel_encoding_size': 24, 'panel_hidden_size': 24, 'panel_n_layers': 1,
      'pattern_encoding_size': 24, 'pattern_hidden_size': 24, 'pattern_n_layers': 1,
      'EConv_hidden': 12, 'EConv_feature': 10, 'k_neighbors': 4, 'conv_depth': 1,
      'skip_connections': True, 'global_pool': 'mean', 'local_attention': True,
      'lstm_init': 'zeros'}
LOSS = {'loss_components': ['shape', 'loop', 'rotation', 'translation'],
        'quality_components': ['shape', 'discrete', 'rotation', 'translation'],
        'panel_order_inariant_loss': False, 'panel_origin_invariant_loss': False,
        'epoch_with_stitches': 100}
SETUP = {'batch_size': 4, 'epochs': 4, 'random_seed': 16, 'learning_rate': 2e-3,
         'optimizer': 'Adam', 'weight_decay': 0, 'lr_scheduling': {'mode': '1cyclic'},
         # patience 1 and a window no loss spans: stops after epoch 2 of 4
         'early_stopping': {'window': 1e9, 'patience': 1}}
SPLIT = {'valid_per_type': 1, 'test_per_type': 1, 'type': 'count', 'random_seed': 10}
LOSS_RTOL, VALID_RTOL, LR_RTOL = 5e-4, 1e-3, 1e-6


class _Interrupt(Exception):
    """Stops a run right after an epoch's checkpoint was written."""


def _dataset(data, root, **extra):
    return data.Garment3DPatternFullDataset(
        root, {'data_folders': FOLDERS, 'mesh_samples': 60,
               'panel_classification': str(root / 'panel_classes.json'), **extra},
        gt_caching=True, feature_caching=True)


def _records(experiment):
    lines = (experiment.run_dir() / 'metrics.jsonl').read_text().splitlines()
    records = [json.loads(line) for line in lines]
    return ([r for r in records if 'batch' in r], [r for r in records if 'valid_loss' in r])


def _interrupt_after(experiment, epoch):
    """Make `experiment.log` raise on `epoch`'s epoch record, which fit
    writes after that epoch's checkpoint: a crash between two epochs."""
    log = experiment.log

    def interrupted(record, step=None):
        log(record, step=step)
        if record.get('epoch') == epoch and 'valid_loss' in record:
            raise _Interrupt()
    experiment.log = interrupted


def _run_jax(root, out, setup, run_id=None, interrupt=None, variables=None):
    dataset = _dataset(jx_data, root)
    exp = jx_experiment.ExperimentWrappper(
        {'experiment': {'project_name': 'fit', 'run_name': 'jax', 'run_id': run_id}},
        output_root=out)
    # one device: a mesh of several would pad the batch of 4 with repeated
    # samples, which the BN statistics would see
    trainer = jx_train.Trainer(dict(setup, mesh={'data': 1}), exp, dataset, dict(SPLIT),
                               with_norm=True)
    trainer.init_randomizer()
    model = jx_build_model('GarmentSegmentPattern3D', dataset.config, NN, LOSS,
                           use_pallas=False)
    if variables is None:
        import jax
        # not the training loader: drawing from it would advance its sampler
        sample = next(iter(trainer.datawrapper.loaders.validation))
        variables = model.init_variables(jax.random.PRNGKey(3),
                                         np.asarray(sample['features'][:2]))
        # host copies: fit donates the device buffers it is given
        variables = jax.tree_util.tree_map(np.array, variables)
    if interrupt is not None:
        _interrupt_after(exp, interrupt)
    try:
        trainer.fit(model, variables)
    except _Interrupt:
        pass
    return exp, variables


def _run_port(root, out, setup, state, run_id=None, interrupt=None, nn=None, loss=None):
    dataset = _dataset(pt_data, root)
    exp = pt_experiment.ExperimentWrappper(
        {'experiment': {'project_name': 'fit', 'run_name': 'port', 'run_id': run_id}},
        output_root=out)
    trainer = pt_train.Trainer(setup, exp, dataset, dict(SPLIT), with_norm=True, device='cpu')
    trainer.init_randomizer()
    model = pt_build_model('GarmentSegmentPattern3D', dataset.config, nn or NN,
                           loss or LOSS, device='cpu')
    if interrupt is not None:
        _interrupt_after(exp, interrupt)
    try:
        trainer.fit(model, state)
    except _Interrupt:
        pass
    return exp, trainer, model


@pytest.fixture(scope='module')
def runs(synthetic_dataset_root, tmp_path_factory):
    """The main pair of runs (4 epochs scheduled, stopped early after 2) and
    the resumed pair (3 epochs with best_by on a metric, interrupted after
    epoch 1, then resumed to the end), each from the same weights."""
    torch.set_num_threads(1)
    root, out = synthetic_dataset_root, tmp_path_factory.mktemp('fit')
    jx_exp, variables = _run_jax(root, out / 'jax', SETUP)
    state = state_dict_from_flax(variables)
    pt_exp, _, _ = _run_port(root, out / 'port', SETUP, state)

    setup = dict(SETUP, epochs=3, early_stopping={'window': 1e-12, 'patience': 50},
                 best_by='num_edges_accuracy')
    jx_first, _ = _run_jax(root, out / 'jax_resume', setup, interrupt=1, variables=variables)
    jx_resumed, _ = _run_jax(root, out / 'jax_resume', setup, run_id=jx_first.run_id,
                             variables=variables)
    pt_first, _, _ = _run_port(root, out / 'port_resume', setup, state, interrupt=1)
    pt_resumed, pt_trainer, pt_model = _run_port(root, out / 'port_resume', setup, state,
                                                 run_id=pt_first.run_id)
    return {'jax': jx_exp, 'port': pt_exp, 'jax_resumed': jx_resumed,
            'port_resumed': pt_resumed, 'port_trainer': pt_trainer, 'port_model': pt_model,
            'state': state}


def _assert_steps_match(ours, theirs):
    assert [(r['epoch'], r['batch'], r['step']) for r in ours] == \
        [(r['epoch'], r['batch'], r['step']) for r in theirs]
    np.testing.assert_allclose([r['loss'] for r in ours], [r['loss'] for r in theirs],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose([r['learning_rate'] for r in ours],
                               [r['learning_rate'] for r in theirs], rtol=LR_RTOL)


def test_fit_step_records_match_jax(runs):
    """Per-step train losses and learning rates of the two fits."""
    ours, _ = _records(runs['port'])
    theirs, _ = _records(runs['jax'])
    assert len(theirs) > 0 and {r['epoch'] for r in theirs} == {0, 1, 2}
    _assert_steps_match(ours, theirs)


def test_fit_validation_best_and_early_stop_match_jax(runs):
    """Per-epoch validation losses, the epoch 'best' points at, and the
    epoch the tight early-stopping rule stops at (2 of 4 scheduled)."""
    _, ours = _records(runs['port'])
    _, theirs = _records(runs['jax'])
    assert [r['epoch'] for r in ours] == [r['epoch'] for r in theirs] == [0, 1, 2]
    np.testing.assert_allclose([r['valid_loss'] for r in ours],
                               [r['valid_loss'] for r in theirs], rtol=VALID_RTOL)
    assert runs['port']._aliases() == runs['jax']._aliases()
    assert runs['port'].summary['stopped early'] == runs['jax'].summary['stopped early']


def test_resumed_fit_matches_jax(runs):
    """An interrupted run resumed from 'latest' continues the step count
    and the schedule as JAX's does: the same records over all three epochs
    as the JAX resumed run, and the learning rates of one uninterrupted
    3-epoch schedule."""
    ours, our_epochs = _records(runs['port_resumed'])
    theirs, their_epochs = _records(runs['jax_resumed'])
    assert runs['port_resumed'].resumed and runs['jax_resumed'].resumed
    assert [r['epoch'] for r in our_epochs] == [r['epoch'] for r in their_epochs] == [0, 1, 2]
    _assert_steps_match(ours, theirs)
    assert [r['step'] for r in ours] == list(range(len(ours)))
    schedule = pt_train.cosine_onecycle_schedule(3 * (len(ours) // 3), SETUP['learning_rate'])
    np.testing.assert_allclose([r['learning_rate'] for r in ours],
                               [schedule(i) for i in range(len(ours))], rtol=LR_RTOL)
    np.testing.assert_allclose([r['valid_loss'] for r in our_epochs],
                               [r['valid_loss'] for r in their_epochs], rtol=VALID_RTOL)


def test_best_by_metric_matches_jax(runs):
    """best_by on a validation metric: the same monitor values, the same
    'best' epoch and the same summary as the JAX run."""
    _, ours = _records(runs['port_resumed'])
    _, theirs = _records(runs['jax_resumed'])
    np.testing.assert_allclose([r['valid_num_edges_accuracy'] for r in ours],
                               [r['valid_num_edges_accuracy'] for r in theirs], rtol=1e-6)
    assert runs['port_resumed']._aliases()['best'] == runs['jax_resumed']._aliases()['best']
    assert runs['port_resumed'].summary['best_monitor'] == pytest.approx(
        runs['jax_resumed'].summary['best_monitor'])


def test_checkpoints_load_back(runs):
    """'best' and 'latest' hold plain tensors: weights_only loading reads
    them, and 'latest' holds the resumed run's final weights and step."""
    exp, trainer, model = runs['port_resumed'], runs['port_trainer'], runs['port_model']
    latest = exp.get_checkpoint_file('latest')
    best = exp.get_best_model()
    assert latest['epoch'] == 2 and latest['step'] == trainer.step_count
    assert set(best) == {'epoch', 'step', 'model', 'optimizer'}
    for key, value in model.module.state_dict().items():
        assert torch.equal(latest['model'][key], value), key
    model.module.load_state_dict(best['model'])
    trainer.optimizer.load_state_dict(best['optimizer'])


def test_fit_without_batches_raises(synthetic_dataset_root, tmp_path):
    """A batch larger than the training split yields no batch: fit raises
    as the JAX trainer does."""
    dataset = _dataset(pt_data, synthetic_dataset_root)
    exp = pt_experiment.ExperimentWrappper({'experiment': {}}, output_root=tmp_path)
    trainer = pt_train.Trainer(dict(SETUP, batch_size=64), exp, dataset, dict(SPLIT),
                               device='cpu')
    model = pt_build_model('GarmentSegmentPattern3D', dataset.config, NN, LOSS, device='cpu')
    with pytest.raises(ValueError, match='produces no batches'):
        trainer.fit(model)


def test_unported_options_raise(synthetic_dataset_root, tmp_path):
    with pytest.raises(NotImplementedError, match='queue A item 6'):
        pt_train.Trainer(SETUP, with_visualization=True, device='cpu')
    dataset = _dataset(pt_data, synthetic_dataset_root)
    dataset.config['on_device_sampling'] = True
    trainer = pt_train.Trainer(SETUP, pt_experiment.ExperimentWrappper({}, tmp_path),
                               dataset, dict(SPLIT), device='cpu')
    model = pt_build_model('GarmentSegmentPattern3D', dataset.config, NN, LOSS, device='cpu')
    with pytest.raises(NotImplementedError, match='on_device_sampling'):
        trainer.fit(model)


def test_f32_tail_on_a_bf16_model(synthetic_dataset_root, tmp_path, monkeypatch):
    """compute_dtype bfloat16 with f32_tail_epochs 1 over 2 epochs: epoch 0
    runs in bf16, epoch 1 in f32 (the MLPs' products then run in f32), the
    parameters stay those of the one optimizer, and the module's compute
    dtypes are back to bf16 after fit."""
    seen = []
    forward = pt_blocks.MLP.forward

    def spy(self, *args, **kwargs):
        seen.append(self.compute_dtype)
        return forward(self, *args, **kwargs)
    monkeypatch.setattr(pt_blocks.MLP, 'forward', spy)
    setup = dict(SETUP, epochs=2, f32_tail_epochs=1,
                 early_stopping={'window': 1e-12, 'patience': 50})
    exp, trainer, model = _run_port(synthetic_dataset_root, tmp_path, setup, None,
                                    nn=dict(NN, compute_dtype='bfloat16'))
    steps, epochs = _records(exp)
    assert [r['compute_dtype'] for r in epochs] == ['bfloat16', 'float32']
    assert all(np.isfinite(r['loss']) for r in steps)
    assert torch.bfloat16 in seen and None in seen
    assert seen.index(None) > 0 and torch.bfloat16 not in seen[seen.index(None):]
    assert all(m.compute_dtype == torch.bfloat16 for m in model.module.modules()
               if isinstance(m, pt_blocks.MLP))
    assert {id(p) for g in trainer.optimizer.param_groups for p in g['params']} == \
        {id(p) for p in model.module.parameters()}


def test_f32_tail_entered_early(synthetic_dataset_root, tmp_path):
    """An early-stop signal in the bf16 phase enters the f32 tail at the
    next epoch instead of stopping, and the summary records it."""
    setup = dict(SETUP, epochs=3, f32_tail_epochs=1,
                 early_stopping={'window': 1e9, 'patience': 0})
    exp, _, _ = _run_port(synthetic_dataset_root, tmp_path, setup, None,
                          nn=dict(NN, compute_dtype='bfloat16'))
    _, epochs = _records(exp)
    assert exp.summary['f32_tail_entered'] == 2
    assert [r['compute_dtype'] for r in epochs] == ['bfloat16', 'bfloat16', 'float32']


def test_kaiming_states_drawn_per_step(synthetic_dataset_root, tmp_path, monkeypatch):
    """With lstm_init kaiming_normal_, each training step draws the LSTM
    initial states from the generator seeded from the run's seed and the
    step, with std sqrt(2 / (batch x hidden)); validation draws from the
    epoch's own stream."""
    draws = []
    initial_states = pt_blocks.LSTMDecoderModule.initial_states

    def spy(self, batch_size, device, generator=None):
        states = initial_states(self, batch_size, device, generator)
        draws.append((self.training, batch_size, self.hidden_size, states[0][0].clone()))
        return states
    monkeypatch.setattr(pt_blocks.LSTMDecoderModule, 'initial_states', spy)
    setup = dict(SETUP, epochs=1)
    exp, trainer, _ = _run_port(synthetic_dataset_root, tmp_path, setup, None,
                                nn=dict(NN, lstm_init='kaiming_normal_'))
    train_draws = [d for d in draws if d[0]]
    assert len(train_draws) == trainer.step_count >= 2
    for step, (_, batch, hidden, h0) in enumerate(train_draws):
        expected = torch.randn(batch, hidden, generator=trainer._generator(step + 1))
        torch.testing.assert_close(h0, expected * (2.0 / (batch * hidden)) ** 0.5,
                                   rtol=0, atol=0)
    stacked = torch.cat([d[3].flatten() * (d[1] * d[2]) ** 0.5 for d in train_draws])
    assert abs(stacked.std().item() - 2 ** 0.5) < 0.1
    assert not torch.equal(train_draws[0][3], train_draws[1][3])
    valid = [d for d in draws if not d[0]][0]
    expected = torch.randn(valid[1], valid[2], generator=trainer._generator(2 ** 20))
    torch.testing.assert_close(valid[3], expected * (2.0 / (valid[1] * valid[2])) ** 0.5,
                               rtol=0, atol=0)
