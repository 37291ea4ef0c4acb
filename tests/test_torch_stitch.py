"""The port's stitch model path against the JAX package's, on the CPU: the
pair classifier's eval and train forwards, its composed loss, one training
step, the bucketed predict and eval helpers, and the stitches a pattern
gets from the classifier; and the shape stage's predict function, which
feeds the stitch dataset.

The same numpy inputs from `default_rng` and the same weights, carried
across by `models.flax_import.state_dict_from_flax`, go through both
packages. Tolerances and their reasons:
  * logits: 1e-5 of their largest magnitude (f32 sums in another order
    through three 200-wide layers);
  * BN running statistics after a train forward: 1e-6 of each buffer's
    largest magnitude (the JAX update goes through a two-row BatchNorm
    whose variance is rounded once more);
  * loss terms on identical logits: 1e-6 (the same f32 formula);
  * one Adam step: loss 1e-6 relative, parameters 1e-5 absolute (the step
    moves them by about 8e-5, the one-cycle schedule's first lr);
  * the shape stage's predictions: 1e-2 of each output's largest magnitude
    at most, 1e-4 on average (the JAX fused EdgeConv Pallas kernel, in
    interpret mode, truncates its edge MLP's inputs to bf16), from the
    port's drawn LSTM states injected into the JAX model.
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import DATA_CONFIG
from garment_pattern_estimation_tpu.core import NNSewingPattern as JaxPattern
from garment_pattern_estimation_tpu.losses.composed import ComposedLoss as JaxComposedLoss
from garment_pattern_estimation_tpu.models import blocks as jax_blocks
from garment_pattern_estimation_tpu.models import build_model as jax_build_model
from garment_pattern_estimation_tpu.train import eval_utils as jax_eval_utils
from garment_pattern_estimation_tpu.train.trainer import Trainer as JaxTrainer
from garment_pattern_estimation_torch.core import NNSewingPattern
from garment_pattern_estimation_torch.losses import ComposedLoss
from garment_pattern_estimation_torch.models import build_model, state_dict_from_flax
from garment_pattern_estimation_torch.models.blocks import LSTMDecoderModule
from garment_pattern_estimation_torch.train import Trainer, eval_utils, phase_of

torch.set_num_threads(1)

DATA = {'element_size': 16}
PUBLISHED = {'stitch_hidden_size': 200, 'stitch_mlp_n_layers': 3}
LOSS = {'loss_components': ['edge_pair_class'],
        'quality_components': ['edge_pair_class', 'edge_pair_stitch_recall']}
SETUP = {'batch_size': 4, 'epochs': 2, 'learning_rate': 0.002, 'optimizer': 'Adam',
         'weight_decay': 0, 'lr_scheduling': {'mode': '1cyclic'}}
STEPS_PER_EPOCH = 3


def _variables(rng, hidden, layers, width=16):
    """Stitch-model flax variables with non-trivial BatchNorm affines and
    running statistics."""
    params, stats = {}, {}
    sizes = [width] + [hidden] * layers + [1]
    for j, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f'Dense_{j}'] = {
            'kernel': (rng.normal(size=(fan_in, fan_out)) / np.sqrt(fan_in)).astype(np.float32),
            'bias': (rng.normal(size=fan_out) * 0.1).astype(np.float32)}
        params[f'BatchNorm_{j}'] = {
            'scale': rng.uniform(0.5, 1.5, fan_out).astype(np.float32),
            'bias': (rng.normal(size=fan_out) * 0.1).astype(np.float32)}
        stats[f'BatchNorm_{j}'] = {
            'mean': (rng.uniform(0.0, 0.5, fan_out)).astype(np.float32),
            'var': rng.uniform(0.5, 2.0, fan_out).astype(np.float32)}
    return {'params': {'mlp': params}, 'batch_stats': {'mlp': stats}}


def _models(nn_config, variables):
    jax_model = jax_build_model('StitchOnEdge3DPairs', DATA, nn_config, LOSS)
    model = build_model('StitchOnEdge3DPairs', DATA, nn_config, LOSS, device='cpu')
    model.module.load_state_dict(state_dict_from_flax(variables))
    return jax_model, model


def _rel_max(ours, theirs):
    theirs = np.asarray(theirs, np.float64)
    return np.abs(np.asarray(ours, np.float64) - theirs).max() / np.abs(theirs).max()


@pytest.mark.parametrize('hidden,layers', [(32, 3), (32, 2), (200, 3)])
def test_forward_matches_jax(hidden, layers):
    rng = np.random.default_rng(hidden + layers)
    variables = _variables(rng, hidden, layers)
    nn_config = {'stitch_hidden_size': hidden, 'stitch_mlp_n_layers': layers}
    jax_model, model = _models(nn_config, variables)
    x = rng.normal(size=(3, 40, 16)).astype(np.float32)

    theirs = np.asarray(jax_model.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        ours = model.module(torch.from_numpy(x)).numpy()
    assert ours.shape == theirs.shape == (3, 40)
    assert _rel_max(ours, theirs) <= 1e-5

    theirs, mutated = jax_model.apply(variables, jnp.asarray(x), train=True)
    model.module.train()
    with torch.no_grad():
        ours = model.module(torch.from_numpy(x), generator=torch.Generator()).numpy()
    assert _rel_max(ours, theirs) <= 1e-5
    ref = state_dict_from_flax({'params': variables['params'],
                                'batch_stats': jax.tree_util.tree_map(
                                    np.asarray, mutated['batch_stats'])})
    running = {k: v for k, v in model.module.state_dict().items() if 'running' in k}
    assert len(running) == 2 * (layers + 1)
    for name, value in running.items():
        assert _rel_max(value.numpy(), ref[name].numpy()) <= 1e-6, name
        # the statistics moved: all B x P rows were reduced
        assert not np.allclose(value.numpy(), state_dict_from_flax(variables)[name].numpy())


def _loss_cases(rng):
    """(logits, gt, mask) cases: random, all predicted negative, no actual
    positives, and a padded batch."""
    logits = (rng.normal(size=(4, 50)) * 2).astype(np.float32)
    gt = rng.integers(0, 2, size=(4, 50)).astype(bool)
    mask = np.arange(50)[None] < rng.integers(20, 51, size=(4, 1))
    return {'random': (logits, gt, None),
            'masked': (logits, gt, mask),
            'no_predicted_positive': (-np.abs(logits) - 0.1, gt, None),
            'no_actual_positive': (logits, np.zeros_like(gt), mask),
            'nothing_positive': (-np.abs(logits) - 0.1, np.zeros_like(gt), None)}


@pytest.mark.parametrize('case', ['random', 'masked', 'no_predicted_positive',
                                  'no_actual_positive', 'nothing_positive'])
def test_composed_loss_matches_jax(case):
    logits, gt, mask = _loss_cases(np.random.default_rng(3))[case]
    jax_loss = JaxComposedLoss(DATA, LOSS)
    loss = ComposedLoss(DATA, LOSS)
    theirs, their_terms, their_flag = jax_loss(
        jnp.asarray(logits), jnp.asarray(gt), mask=None if mask is None else jnp.asarray(mask))
    ours, our_terms, flag = loss(torch.from_numpy(logits), torch.from_numpy(gt),
                                 mask=None if mask is None else torch.from_numpy(mask))
    assert flag is their_flag is False
    assert set(our_terms) == set(their_terms) == {
        'edge_pair_class_loss', 'edge_pair_class_acc', 'stitch_precision', 'stitch_recall'}
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-6, atol=1e-6)
    for key, value in our_terms.items():
        assert value.dim() == 0
        np.testing.assert_allclose(float(value), float(their_terms[key]), rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    if case in ('no_predicted_positive', 'nothing_positive'):
        assert float(our_terms['stitch_precision']) == 0.0
    if case in ('no_actual_positive', 'nothing_positive'):
        assert float(our_terms['stitch_recall']) == 0.0


def test_composed_loss_keeps_the_trainers_interface():
    """`with_quality_eval` off leaves the loss alone; `train()`/`eval()`
    and the config are there for Trainer.fit."""
    loss = ComposedLoss(DATA, LOSS)
    loss.train()
    assert loss.training
    loss.eval()
    assert not loss.training and loss.config['loss_components'] == ['edge_pair_class']
    loss.with_quality_eval = False
    logits = torch.zeros(2, 5, requires_grad=True)
    value, terms, _ = loss(logits, torch.ones(2, 5, dtype=torch.bool), epoch=3,
                           generator=torch.Generator())
    assert set(terms) == {'edge_pair_class_loss'}
    value.backward()
    assert logits.grad is not None


def test_train_step_matches_jax():
    """One Trainer.train_step against the JAX trainer's `_train_step_fn` on
    a (4, 40, 16) batch from the same weights: the loss, its terms, every
    parameter after Adam and the running statistics."""
    rng = np.random.default_rng(21)
    variables = _variables(rng, 32, 3)
    jax_model, model = _models({'stitch_hidden_size': 32}, variables)
    features = rng.normal(size=(4, 40, 16)).astype(np.float32)
    gt = rng.integers(0, 2, size=(4, 40)).astype(bool)

    jt = JaxTrainer.__new__(JaxTrainer)
    jt.setup, jt._step_cache = dict(SETUP), {}
    tx = jt._make_optimizer(STEPS_PER_EPOCH)
    step = jt._train_step_fn(jax_model, tx, phase_of(LOSS, 0), 4)
    params, stats, _, jax_loss, jax_terms = step(
        variables['params'], variables['batch_stats'], tx.init(variables['params']),
        {'features': jnp.asarray(features), 'ground_truth': jnp.asarray(gt)},
        jax.random.PRNGKey(0))
    ref = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {'params': params, 'batch_stats': stats}))

    trainer = Trainer(SETUP, device='cpu')
    trainer.make_optimizer(model, STEPS_PER_EPOCH)
    loss, terms = trainer.train_step(
        model, {'features': torch.from_numpy(features), 'ground_truth': torch.from_numpy(gt)},
        0, torch.Generator().manual_seed(1))
    np.testing.assert_allclose(float(loss), float(jax_loss), rtol=1e-6)
    assert set(terms) == set(jax_terms)
    for key, value in terms.items():
        np.testing.assert_allclose(float(value), float(jax_terms[key]), rtol=1e-6, atol=1e-6)
    before = state_dict_from_flax(variables)
    for name, value in model.module.state_dict().items():
        if 'num_batches' in name:
            continue
        if 'running' in name:
            assert _rel_max(value.numpy(), ref[name].numpy()) <= 1e-6, name
        else:
            assert np.abs(value.numpy() - ref[name].numpy()).max() <= 1e-5, name
            assert not np.array_equal(value.numpy(), before[name].numpy()), name


@pytest.mark.parametrize('n', [1, 5, 31, 32, 33, 64, 100, 1000, 1024, 1025])
def test_bucket_size_and_pad_match_jax(n):
    assert eval_utils._bucket_size(n) == jax_eval_utils._bucket_size(n)
    rng = np.random.default_rng(n)
    features = rng.normal(size=(1, n, 16)).astype(np.float32)
    gt = rng.integers(0, 2, size=(1, n)).astype(bool)
    for ours, theirs in zip(eval_utils._bucket_pad(features, gt),
                            jax_eval_utils._bucket_pad(features, gt)):
        assert ours.dtype == theirs.dtype
        np.testing.assert_array_equal(ours, theirs)


def test_bucketed_prediction_equals_unpadded():
    """make_predict_fn(bucket_pairs=True) pads (n, 16) pairs to the bucket
    and cuts the logits back: equal to the unpadded eval forward, and to the
    JAX package's bucketed predict function."""
    rng = np.random.default_rng(8)
    variables = _variables(rng, 200, 3)
    jax_model, model = _models(PUBLISHED, variables)
    predict = eval_utils.make_predict_fn(model, bucket_pairs=True)
    jax_predict = jax_eval_utils.make_predict_fn(jax_model, variables, bucket_pairs=True)
    for n in (7, 32, 45, 300):
        pairs = rng.normal(size=(n, 16)).astype(np.float32)
        ours = predict(pairs)
        with torch.no_grad():
            plain = model.module.eval()(torch.from_numpy(pairs)).numpy()
        assert ours.shape == (n,) and isinstance(ours, np.ndarray)
        np.testing.assert_allclose(ours, plain, rtol=1e-6, atol=1e-6)
        assert _rel_max(ours, jax_predict(pairs)) <= 1e-5


def test_eval_metrics_bucketed_and_masked_match_jax():
    """eval_metrics over variable pair counts at batch 1 (the exhaustive
    mode) takes the bucketed, masked path on both sides; a NaN metric is
    skipped batch by batch. A device sampler samples mesh-dict batches
    only: pair batches pass it by, as in the JAX package."""
    rng = np.random.default_rng(17)
    variables = _variables(rng, 32, 3)
    jax_model, model = _models({'stitch_hidden_size': 32}, variables)
    batches = [{'features': rng.normal(size=(1, n, 16)).astype(np.float32),
                'ground_truth': rng.integers(0, 2, size=(1, n)).astype(bool)}
               for n in (20, 45, 64, 90)]

    class Wrapper:
        def __init__(self, convert):
            self.dataset = type('D', (), {'config': {}})()
            self.convert = convert

        def get_loader(self, section):
            loader = [{k: self.convert(v) for k, v in b.items()} for b in batches]
            return {'a': loader[:2], 'b': loader[2:]} if section == 'per_folder' else loader

    theirs = jax_eval_utils.eval_metrics(jax_model, variables, Wrapper(np.asarray), 'test')
    ours = eval_utils.eval_metrics(model, None, Wrapper(torch.from_numpy), 'test')
    assert set(ours) == set(theirs) == {'full_loss', 'edge_pair_class_loss',
                                        'edge_pair_class_acc', 'stitch_precision',
                                        'stitch_recall'}
    for key, value in ours.items():
        np.testing.assert_allclose(value, theirs[key], rtol=1e-5, atol=1e-6, err_msg=key)
    per_folder = eval_utils.eval_metrics(model, None, Wrapper(torch.from_numpy), 'per_folder')
    assert set(per_folder) == {'a', 'b'}
    assert eval_utils.eval_metrics(model, None, Wrapper(torch.from_numpy), 'test',
                                   device_sampler=object()) == ours


def _spec(synthetic_dataset_root):
    return next(synthetic_dataset_root.glob('jumpsuit_synth_300/*/specification.json'))


def test_stitches_from_pair_classifier_match_jax(synthetic_dataset_root):
    """Both packages' patterns take their stitches from both packages'
    bucketed predict functions on the same weights: the same stitch list
    (panels, edges), scores within 1e-5 of their scale."""
    rng = np.random.default_rng(4)
    variables = _variables(rng, 200, 3)
    jax_model, model = _models(PUBLISHED, variables)
    spec = _spec(synthetic_dataset_root)
    n_pairs = len(NNSewingPattern(spec).all_edge_pairs()[0])
    stats = {'f_shift': rng.normal(size=16).tolist(),
             'f_scale': rng.uniform(0.5, 2.0, 16).tolist()}

    ours, theirs = NNSewingPattern(spec), JaxPattern(spec)
    ours.stitches_from_pair_classifier(
        eval_utils.make_predict_fn(model, bucket_pairs=True), stats)
    theirs.stitches_from_pair_classifier(
        jax_eval_utils.make_predict_fn(jax_model, variables, bucket_pairs=True), stats)
    assert 0 < len(ours.pattern['stitches']) < n_pairs

    def sides(stitches):
        return [[(s['panel'], s['edge']) for s in stitch] for stitch in stitches]
    assert sides(ours.pattern['stitches']) == sides(theirs.pattern['stitches'])
    scores = np.array([s[0]['score'] for s in ours.pattern['stitches']])
    ref = np.array([s[0]['score'] for s in theirs.pattern['stitches']])
    assert np.abs(scores - ref).max() <= 1e-5 * np.abs(ref).max()


# the shape stage: the attention model at small widths, its predict
# function drawing the LSTM states as JAX's does
SHAPE_DATA = dict(DATA_CONFIG, max_panel_len=5, max_pattern_len=4)
SHAPE_NN = {'panel_encoding_size': 16, 'panel_hidden_size': 16, 'panel_n_layers': 2,
            'EConv_hidden': 12, 'EConv_feature': 10, 'EConv_hidden_depth': 2,
            'k_neighbors': 4, 'conv_depth': 2, 'skip_connections': True,
            'global_pool': 'mean', 'local_attention': True, 'lstm_init': 'kaiming_normal_'}


def test_shape_predict_fn_with_drawn_states_matches_jax(monkeypatch):
    """The shape stage's make_predict_fn draws the LSTM initial states from
    a generator seeded from rng_seed and the call count (a new draw per
    call, the same draws for the same seed); with those states injected
    into the JAX model, its predict function gives the same predictions."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 48, 3)).astype(np.float32)
    jax_model = jax_build_model('GarmentSegmentPattern3D', SHAPE_DATA, SHAPE_NN,
                                use_pallas=True)
    variables = jax.tree_util.tree_map(np.asarray, jax_model.init_variables(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    model = build_model('GarmentSegmentPattern3D', SHAPE_DATA, SHAPE_NN, device='cpu')
    state = state_dict_from_flax(variables)

    drawn = []
    draw = LSTMDecoderModule.initial_states

    def recording(self, *args, **kwargs):
        drawn.append(draw(self, *args, **kwargs))
        return drawn[-1]

    monkeypatch.setattr(LSTMDecoderModule, 'initial_states', recording)
    predict = eval_utils.make_predict_fn(model, state, rng_seed=3)
    ours = predict(torch.from_numpy(x))
    again = predict(x)
    assert len(drawn) == 2
    assert not torch.equal(drawn[0][0][0], drawn[1][0][0])
    eval_utils.make_predict_fn(model, rng_seed=3)(x)
    assert torch.equal(drawn[0][0][0], drawn[2][0][0])
    assert not np.allclose(ours['outlines'], again['outlines'])

    def inject(self, module, batch_size, n_layers, hidden, with_cell=True):
        assert module.has_rng('recurrent_init')
        return [(jnp.asarray(h.numpy()), jnp.asarray(c.numpy())) for h, c in drawn[0]]

    monkeypatch.setattr(jax_blocks._StateInitMixin, '_init_states', inject)
    theirs = jax_eval_utils.make_predict_fn(jax_model, variables)(x)
    assert set(ours) == set(theirs)
    for key in ('outlines', 'rotations', 'translations', 'stitch_tags', 'free_edges_mask'):
        assert ours[key].shape == theirs[key].shape, key
        scale = np.abs(theirs[key]).max()
        gap = np.abs(ours[key] - theirs[key])
        assert gap.max() <= 1e-2 * scale and gap.mean() <= 1e-4 * scale, key


def test_predict_fn_sampler_raises():
    """make_predict_fn takes a device sampler (it used to refuse one), which
    samples mesh-dict features only: pair features pass it by, as in the
    JAX package; a mesh dict without a sampler raises ValueError."""
    model = build_model('StitchOnEdge3DPairs', DATA, {}, device='cpu')
    x = np.random.default_rng(0).normal(size=(2, 7, 16)).astype(np.float32)
    np.testing.assert_array_equal(eval_utils.make_predict_fn(model, device_sampler=copy.copy)(x),
                                  eval_utils.make_predict_fn(model)(x))
    with pytest.raises(ValueError, match='device_sampler'):
        eval_utils.make_predict_fn(model)({'verts': np.zeros((1, 4, 3), np.float32)})
