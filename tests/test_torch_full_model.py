"""The baseline model `GarmentFullPattern3D` (configs/lstm_stitch_tags.yaml)
in the port against the JAX package: the eval forward, the composed loss
with the config's loss section (panel-order and loop-origin matching, the
stitch-tag loss, free-edge classification, stitch precision/recall) and one
training step in each loss phase.

JAX's EdgeConv runs its Pallas kernels in interpret mode (use_pallas=True),
the port its plain versions; weights cross through `state_dict_from_flax`.
The LSTM initial states are zeros on both sides (no generator, no
'recurrent_init' rng).

Tolerances and their reasons:
  * eval forward at small widths (EConv 12/10, so both conv layers take the
    small-C selection, whose ids are exact): every output within 1e-4 of its
    largest magnitude;
  * eval forward at the config's widths on a small cloud: 1e-2 of each
    output's largest magnitude at most, 1e-4 on average (a flipped bf16
    truncation in the wide-C edge MLP, as tests/test_torch_model.py);
  * the composed loss on shared predictions: 1e-4 relative (f32 sums in
    another order through the matchings' distances);
  * one train step: the loss within 1e-4 relative, each parameter's
    gradient within 1e-3 of its largest magnitude, the BN running
    statistics within 1e-5 of each buffer's (tests/test_torch_train.py's
    bars and reasons).
"""
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from __graft_entry__ import DATA_CONFIG
from garment_pattern_estimation_tpu.experiment.torch_import import import_shape_model
from garment_pattern_estimation_tpu.losses.composed import (
    ComposedPatternLoss as JaxComposedPatternLoss)
from garment_pattern_estimation_tpu.models import build_model as jax_build_model
from garment_pattern_estimation_torch.losses import ComposedPatternLoss
from garment_pattern_estimation_torch.models import (
    GarmentFullPattern3DModule, build_model, state_dict_from_flax)
from garment_pattern_estimation_torch.train import Trainer
import test_torch_train as torch_train
from test_torch_canonicalization import make_ground_truth, make_predictions

torch.set_num_threads(1)

CONFIG = yaml.safe_load(
    (Path(__file__).resolve().parents[1] / 'configs' / 'lstm_stitch_tags.yaml').read_text())
NN = CONFIG['NN']                              # the NN section, unchanged
LOSS = NN['loss']
MODEL = NN['model']
KEYS = ('outlines', 'rotations', 'translations', 'stitch_tags', 'free_edges_mask')
SMALL = {'EConv_hidden': 12, 'EConv_feature': 10, 'panel_encoding_size': 16,
         'panel_hidden_size': 16, 'pattern_encoding_size': 16, 'pattern_hidden_size': 16}


def _perturb(tree, rng):
    """BN statistics moved off the identity, so every fold does work."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _perturb(value, rng)
        elif key == 'var':
            out[key] = value + rng.uniform(0.1, 0.5, value.shape).astype(np.float32)
        else:
            out[key] = value + 0.1 * rng.normal(size=value.shape).astype(np.float32)
    return out


def shared_model(data, nn_config, x, seed=0):
    """(JAX model, its variables as numpy, the port model on the same weights)."""
    rng = np.random.default_rng(seed)
    jax_model = jax_build_model(MODEL, data, nn_config, LOSS, use_pallas=True)
    variables = jax.tree_util.tree_map(
        np.asarray, jax_model.init_variables(jax.random.PRNGKey(seed), jnp.asarray(x)))
    variables = {'params': variables['params'],
                 'batch_stats': _perturb(variables['batch_stats'], rng)}
    model = build_model(MODEL, data, nn_config, LOSS, device='cpu')
    model.module.load_state_dict(state_dict_from_flax(variables))
    return jax_model, variables, model


def _forwards(data, nn_config, x):
    jax_model, variables, model = shared_model(data, nn_config, x)
    ref = jax.jit(lambda v, x: jax_model.module.apply(v, x, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert sorted(out) == sorted(ref) == sorted(KEYS)
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in out.items()}, \
        model, variables


def test_config_builds_the_full_model():
    """The NN section unchanged: the baseline module with its global head,
    the pattern decoder (23 panel encodings of 250 from a 2-layer LSTM) and
    the loss section merged over the registry's defaults."""
    data = {k: CONFIG['dataset'][k] for k in ('element_size', 'rotation_size',
                                              'translation_size', 'max_panel_len',
                                              'max_pattern_len')}
    model = build_model(MODEL, data, NN, LOSS, device='cpu')
    module = model.module
    assert type(module) is GarmentFullPattern3DModule
    assert module.feature_extractor.lin.out_features == 250
    assert (module.pattern_decoder.out_len, module.pattern_decoder.n_layers) == (23, 2)
    assert (module.panel_decoder.out_len, module.panel_decoder.n_layers) == (14, 3)
    assert module.placement_decoder.out_features == 7
    assert 'local_attention' not in model.config and model.config['model'] == MODEL
    assert model.loss.config['order_by'] == 'shape_translation'
    assert model.loss.config['panel_order_inariant_loss'] is True
    assert not any(k.startswith('point_segment_mlp') for k in module.state_dict())


def test_eval_forward_matches_jax_small():
    data = dict(DATA_CONFIG, max_pattern_len=3, max_panel_len=4)
    x = np.random.default_rng(1).normal(size=(2, 48, 3)).astype(np.float32)
    ref, out, model, variables = _forwards(data, dict(NN, **SMALL), x)
    for key in KEYS:
        scale = float(np.abs(ref[key]).max())
        assert np.abs(out[key] - ref[key]).max() <= 1e-4 * scale, key
    sd = state_dict_from_flax(variables)
    assert set(sd) == set(model.module.state_dict())
    assert {'pattern_decoder.lstm.weight_hh_l1', 'pattern_decoder.lin.weight',
            'feature_extractor.lin.weight'} <= set(sd)


def test_eval_forward_matches_jax_at_config_widths(tmp_path):
    """Also the cross-check of the names: the port's state dict saved as a
    .pth loads back into the JAX package's flax tree unchanged."""
    x = np.random.default_rng(2).normal(size=(2, 64, 3)).astype(np.float32)
    ref, out, model, variables = _forwards(dict(DATA_CONFIG), NN, x)
    for key in KEYS:
        scale = float(np.abs(ref[key]).max())
        diff = np.abs(out[key] - ref[key])
        assert diff.max() <= 1e-2 * scale and diff.mean() <= 1e-4 * scale, key

    path = tmp_path / 'lstm_stitch_tags.pth'
    torch.save(model.module.state_dict(), path)
    back = import_shape_model(path, model_name=MODEL)['variables']
    flat = lambda tree: {jax.tree_util.keystr(k): np.asarray(v) for k, v
                         in jax.tree_util.tree_leaves_with_path(tree)}
    theirs, ours = flat(variables), flat(back)
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key], value, err_msg=key)


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope='module')
def loss_inputs():
    rng = np.random.default_rng(31)
    gt = make_ground_truth(rng)
    return make_predictions(rng, gt), gt


@pytest.mark.parametrize('epoch', [0, 39, 40])
def test_composed_loss_matches_jax(loss_inputs, epoch):
    preds, gt = loss_inputs
    jax_loss, flags = JaxComposedPatternLoss(DATA_CONFIG, LOSS), []

    def traced(p, g):
        loss, terms, flag = jax_loss(p, g, epoch=epoch)
        flags.append(flag)                 # a Python bool, set while tracing
        return loss, terms
    j_loss, j_terms = jax.jit(traced)(_jax(preds), _jax(gt))
    j_flag, = flags
    t_loss, t_terms, t_flag = ComposedPatternLoss(DATA_CONFIG, LOSS)(
        _torch(preds), _torch(gt), epoch=epoch)
    assert sorted(t_terms) == sorted(j_terms)
    assert t_flag == j_flag == (epoch in (0, 40))       # order matching at 0, stitches at 40
    assert ('stitch_recall' in t_terms) == (epoch >= 40)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-4)
    for key, value in j_terms.items():
        np.testing.assert_allclose(float(t_terms[key]), float(value), rtol=1e-4, atol=1e-7,
                                   err_msg=key)


def test_random_order_warmup_needs_a_generator(loss_inputs):
    """Before epoch_with_order_matching the GT panels take a random order:
    drawn from the generator, as the JAX loss draws from its rng; without
    one both raise."""
    preds, gt = loss_inputs
    config = dict(LOSS, epoch_with_order_matching=5)
    with pytest.raises(ValueError, match='requires an rng'):
        JaxComposedPatternLoss(DATA_CONFIG, config)(_jax(preds), _jax(gt), epoch=2)
    loss = ComposedPatternLoss(DATA_CONFIG, config)
    with pytest.raises(ValueError, match='requires a generator'):
        loss(_torch(preds), _torch(gt), epoch=2)
    first, _, flag = loss(_torch(preds), _torch(gt), epoch=2,
                          generator=torch.Generator().manual_seed(0))
    again, _, _ = loss(_torch(preds), _torch(gt), epoch=2,
                       generator=torch.Generator().manual_seed(0))
    matched, _, _ = loss(_torch(preds), _torch(gt), epoch=5)
    assert float(first) == float(again) and not flag
    assert float(matched) < float(first)            # the matched order fits better


# one training step, as tests/test_torch_train.py's training_runs builds it,
# on its batch shapes and ground truth with the dataset's stitch keys
TRAIN_NN = dict(NN, EConv_hidden=16, EConv_feature=24, panel_encoding_size=32,
                panel_hidden_size=32, pattern_encoding_size=32, pattern_hidden_size=32,
                lstm_init='')


def _train_batch(rng):
    gt = torch_train._with_stitches(rng, torch_train._ground_truth(rng))
    return {'features': rng.normal(size=(torch_train.B, torch_train.N, 3)).astype(np.float32),
            'ground_truth': gt}


@pytest.fixture(scope='module', params=[0, 40], ids=['epoch0', 'epoch40'])
def train_step_pair(request):
    """The port's `Trainer.train_step` (one Adam step) and the JAX train
    forward + loss + gradient from the same weights at the epoch: losses,
    terms, gradients and running statistics."""
    epoch = request.param
    rng = np.random.default_rng(17)
    batch = _train_batch(rng)
    jax_model = jax_build_model(MODEL, torch_train.DATA, TRAIN_NN, LOSS, use_pallas=True)
    variables = jax.tree_util.tree_map(np.asarray, jax_model.init_variables(
        jax.random.PRNGKey(0), jnp.asarray(batch['features'])))
    def loss_fn(p, features, gt):
        preds, mutated = jax_model.module.apply(
            {'params': p, 'batch_stats': variables['batch_stats']}, features, train=True,
            mutable=['batch_stats'])
        loss, terms, _ = jax_model.loss(preds, gt, epoch=epoch)
        return loss, (terms, mutated['batch_stats'])

    (loss, (terms, stats)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables['params'], jnp.asarray(batch['features']), _jax(batch['ground_truth']))
    stats = jax.tree_util.tree_map(np.asarray, stats)
    jax_side = {'loss': float(loss), 'terms': {k: float(v) for k, v in terms.items()},
                'grads': state_dict_from_flax({'params': jax.tree_util.tree_map(
                    np.asarray, grads), 'batch_stats': stats}),
                'stats': state_dict_from_flax({'params': variables['params'],
                                               'batch_stats': stats})}

    model = build_model(MODEL, torch_train.DATA, TRAIN_NN, LOSS, device='cpu')
    model.module.load_state_dict(state_dict_from_flax(variables))
    trainer = Trainer(torch_train.SETUP, device='cpu')
    trainer.make_optimizer(model, 1)
    t_loss, t_terms = trainer.train_step(
        model, {'features': torch.from_numpy(batch['features']),
                'ground_truth': _torch(batch['ground_truth'])}, epoch)
    torch_side = {'loss': float(t_loss), 'terms': {k: float(v) for k, v in t_terms.items()},
                  'grads': {n: p.grad.clone() for n, p in model.module.named_parameters()},
                  'stats': {k: v.clone() for k, v in model.module.state_dict().items()
                            if 'running' in k}}
    return epoch, jax_side, torch_side


def test_train_step_loss_and_terms_match_jax(train_step_pair):
    epoch, theirs, ours = train_step_pair
    np.testing.assert_allclose(ours['loss'], theirs['loss'], rtol=1e-4)
    assert sorted(ours['terms']) == sorted(theirs['terms'])
    stitch_terms = {'stitch_similarity_loss', 'stitch_neg_loss', 'free_edges_loss',
                    'stitch_recall'}
    assert (stitch_terms <= set(ours['terms'])) == (epoch >= 40)
    for key in ('pattern_loss', 'loop_loss', 'rotation_loss', 'translation_loss',
                *(stitch_terms - {'stitch_recall'} if epoch >= 40 else ())):
        np.testing.assert_allclose(ours['terms'][key], theirs['terms'][key], rtol=1e-4,
                                   err_msg=key)


def test_train_step_gradients_match_jax(train_step_pair):
    _, theirs, ours = train_step_pair
    assert set(ours['grads']) == {k for k in theirs['grads'] if 'running' not in k
                                  and 'num_batches' not in k}
    assert any(k.startswith('pattern_decoder.') for k in ours['grads'])
    for name, grad in ours['grads'].items():
        ref = theirs['grads'][name].numpy()
        scale = float(np.abs(ref).max())
        assert scale > 0, name
        assert np.abs(grad.numpy() - ref).max() <= 1e-3 * scale, name


def test_train_step_running_stats_match_jax(train_step_pair):
    _, theirs, ours = train_step_pair
    assert len(ours['stats']) == 2 * 3 * 2             # 2 conv MLPs, 3 BNs, mean + var
    for name, value in ours['stats'].items():
        ref = theirs['stats'][name].numpy()
        assert np.abs(value.numpy() - ref).max() <= 1e-5 * float(np.abs(ref).max()), name
