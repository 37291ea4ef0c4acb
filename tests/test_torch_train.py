"""The port's training path against the JAX package's: the loss components
and the composed loss on identical predictions, the one-cycle schedule,
and the training step of the whole attention model.

The model is cut to small widths (N=128 points, EConv 16/24 so conv1 takes
the wide-C path, panel hidden 32, 2 LSTM layers, 6 panels x 5 edges) with
`lstm_init: ''`, so the LSTM states are zeros on both sides. The JAX model
is built with use_pallas=True: on the CPU its train-mode EdgeConv runs the
knn_gather Pallas kernels in interpret mode; the port runs its plain
versions. Weights cross through `state_dict_from_flax`.

Tolerances and their reasons:
  * loss terms on identical predictions: 1e-5 relative, 1e-6 absolute (f32
    reductions in another order);
  * schedule: 1e-6 relative (both take the cosine in f32);
  * step 0 loss: 1e-4 relative, the bar of test_train_parity.py at step 0
    (f32 sums in another order through the whole model);
  * step 0 gradients: 1e-3 of each parameter's largest gradient (the JAX
    knn_gather backward scatters two bf16 chunks of the cotangent, the port
    the full f32 value, and the sums run in another order);
  * BN running statistics after one step: 1e-5 of each buffer's largest
    magnitude (the JAX update goes through a two-row BatchNorm whose
    variance is rounded once more);
  * the 4-step loss trajectory: 5e-3 relative, test_train_parity.py's bar
    (the differences above compound through Adam).
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from __graft_entry__ import DATA_CONFIG
from garment_pattern_estimation_tpu.losses import components as jax_components
from garment_pattern_estimation_tpu.losses.composed import (
    ComposedPatternLoss as JaxComposedPatternLoss)
from garment_pattern_estimation_tpu.models import blocks as jax_blocks
from garment_pattern_estimation_tpu.models import build_model as jax_build_model
from garment_pattern_estimation_tpu.train.trainer import Trainer as JaxTrainer
from garment_pattern_estimation_torch.losses import ComposedPatternLoss, components
from garment_pattern_estimation_torch.models import build_model, state_dict_from_flax
from garment_pattern_estimation_torch.models.blocks import LSTMDecoderModule
from garment_pattern_estimation_torch.models.registry import init_weights
from garment_pattern_estimation_torch.train import (
    Trainer, canonical_epoch, cosine_onecycle_schedule, phase_of)

torch.set_num_threads(1)

B, N, P, L = 2, 128, 6, 5
DATA = dict(DATA_CONFIG, max_panel_len=L, max_pattern_len=P)
NN = {'panel_encoding_size': 32, 'panel_hidden_size': 32, 'panel_n_layers': 2,
      'EConv_hidden': 16, 'EConv_feature': 24, 'EConv_hidden_depth': 2,
      'k_neighbors': 5, 'conv_depth': 2, 'skip_connections': True,
      'global_pool': 'mean', 'local_attention': True, 'lstm_init': ''}
# configs/att.yaml's loss section
LOSS = {'loss_components': ['shape', 'loop', 'rotation', 'translation'],
        'quality_components': ['shape', 'discrete', 'rotation', 'translation'],
        'loop_loss_weight': 1.0, 'segm_loss_weight': 0.05, 'epoch_with_stitches': 40,
        'panel_origin_invariant_loss': False, 'panel_order_inariant_loss': False,
        'epoch_with_order_matching': 0, 'order_by': 'shape_translation'}
SETUP = {'batch_size': B, 'epochs': 2, 'learning_rate': 0.002, 'optimizer': 'Adam',
         'weight_decay': 0, 'lr_scheduling': {'mode': '1cyclic'}}
STEPS_PER_EPOCH = 2


def _ground_truth(rng, batch=B, P=P, L=L, N=N):
    """Ground truth in the dataset's shapes, standardized: panels beyond
    each pattern's count and edges beyond each panel's count hold the pad
    vector."""
    pad = np.asarray(jax_components.eval_pad_vector(
        {k: DATA['standardize'][f'gt_{k}']['outlines'] for k in ('shift', 'scale')}))
    num_panels = rng.integers(2, P + 1, size=batch)
    num_edges = np.where(np.arange(P)[None] < num_panels[:, None],
                         rng.integers(3, L + 1, size=(batch, P)), 0)
    outlines = (rng.normal(size=(batch, P, L, 4)) * 0.3).astype(np.float32)
    outlines = np.where((np.arange(L)[None, None] < num_edges[..., None])[..., None],
                        outlines, pad).astype(np.float32)
    return {'outlines': outlines,
            'rotations': (rng.normal(size=(batch, P, 4)) * 0.3).astype(np.float32),
            'translations': (rng.normal(size=(batch, P, 3)) * 0.3).astype(np.float32),
            'stitch_tags': rng.normal(size=(batch, P, L, 3)).astype(np.float32),
            'free_edges_mask': rng.integers(0, 2, size=(batch, P, L)).astype(bool),
            'num_edges': num_edges.astype(np.int32),
            'num_panels': num_panels.astype(np.int32),
            'segmentation': rng.integers(0, P, size=(batch, N)).astype(np.int32)}


def _predictions(rng, gt):
    """Near the ground truth for the first half of the batch (so the
    discrete metrics find correct patterns), random for the rest."""
    batch = gt['outlines'].shape[0]
    near = (np.arange(batch) < batch // 2)
    preds = {}
    for key, shape in (('outlines', (P, L, 4)), ('rotations', (P, 4)),
                       ('translations', (P, 3)), ('stitch_tags', (P, L, 3))):
        noise = rng.normal(size=(batch, *shape)).astype(np.float32)
        scale = np.where(near, 0.005, 0.5).reshape(-1, *([1] * len(shape)))
        preds[key] = (gt[key] + scale * noise).astype(np.float32)
    preds['free_edges_mask'] = rng.normal(size=(batch, P, L)).astype(np.float32)
    preds['att_weights'] = np.asarray(jax.nn.softmax(
        jnp.asarray(rng.normal(size=(batch, N, P)).astype(np.float32) * 3)))
    return preds


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(ours, theirs, rtol=1e-5, atol=1e-6, msg=''):
    np.testing.assert_allclose(np.asarray(ours, np.float64), np.asarray(theirs, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture()
def loss_inputs(rng):
    gt = _ground_truth(rng)
    return _predictions(rng, gt), gt


def test_loss_components_match_jax(loss_inputs):
    preds, gt = loss_inputs
    stats = {k: DATA['standardize'][f'gt_{k}']['outlines'] for k in ('shift', 'scale')}
    pad, jpad = components.eval_pad_vector(stats), jax_components.eval_pad_vector(stats)
    _close(pad, jpad)
    tp, tg, jp, jg = _torch(preds), _torch(gt), _jax(preds), _jax(gt)
    _close(components.panel_loop_loss(tp['outlines'], tg['num_edges'], pad),
           jax_components.panel_loop_loss(jp['outlines'], jg['num_edges'], jpad))
    _close(components.bce_with_logits(tp['free_edges_mask'], tg['free_edges_mask']),
           jax_components.bce_with_logits(jp['free_edges_mask'], jg['free_edges_mask']))
    ours = components.numbers_in_panels_accuracies(
        tp['outlines'], tg['num_edges'], tg['num_panels'], pad, stats['scale'])
    theirs = jax_components.numbers_in_panels_accuracies(
        jp['outlines'], jg['num_edges'], jg['num_panels'], jpad, stats['scale'])
    for o, th in zip(ours, theirs):
        _close(o, th)
    assert 0 < float(ours[0]) < 1          # some patterns right, some wrong
    mask_t, mask_j = ours[2], theirs[2]
    _close(components.panel_verts_l2(tp['outlines'], tg['outlines'], tg['num_edges'],
                                     stats['shift'], stats['scale'], mask_t),
           jax_components.panel_verts_l2(jp['outlines'], jg['outlines'], jg['num_edges'],
                                         stats['shift'], stats['scale'], mask_j))
    rot = {k: DATA['standardize'][f'gt_{k}']['rotations'] for k in ('shift', 'scale')}
    _close(components.universal_l2(tp['rotations'], tg['rotations'], rot['shift'],
                                   rot['scale'], mask_t),
           jax_components.universal_l2(jp['rotations'], jg['rotations'], rot['shift'],
                                       rot['scale'], mask_j))
    _close(components._panels_to_verts(tp['outlines'].reshape(-1, L, 4)),
           jax_components._panels_to_verts(jp['outlines'].reshape(-1, L, 4)))
    assert components._torch_isclose(torch.tensor(1.0), torch.tensor(1.05), atol=0.07)


@pytest.mark.parametrize('extra_losses,extra_quality,epoch', [
    ((), (), 0),                                            # configs/att.yaml
    (('segmentation',), (), 3),
    (('stitch_supervised', 'free_class'), ('free_class',), 40),   # stitch phase
])
def test_composed_loss_matches_jax(loss_inputs, extra_losses, extra_quality, epoch):
    preds, gt = loss_inputs
    config = dict(LOSS, loss_components=LOSS['loss_components'] + list(extra_losses),
                  quality_components=LOSS['quality_components'] + list(extra_quality))
    j_loss, j_terms, j_flag = JaxComposedPatternLoss(DATA, config)(
        _jax(preds), _jax(gt), epoch=epoch)
    t_loss, t_terms, t_flag = ComposedPatternLoss(DATA, config)(
        _torch(preds), _torch(gt), epoch=epoch)
    assert sorted(t_terms) == sorted(j_terms)
    assert t_flag == j_flag == (epoch == 40)
    _close(t_loss, j_loss)
    for key in j_terms:
        _close(t_terms[key], j_terms[key], msg=key)


def _with_stitches(rng, gt):
    """The GT's stitches (B, 2, S) between edges inside the loops (zeros
    past each count), the free-edge mask they leave and the empty-panel
    mask, as the dataset gives them."""
    S = DATA['max_num_stitches']
    stitches = np.zeros((B, 2, S), np.int64)
    num_stitches = rng.integers(1, S + 1, size=B)
    free = np.ones((B, P, L), bool)
    for b in range(B):
        edges = [p * L + e for p in range(P) for e in range(gt['num_edges'][b, p])]
        n = min(num_stitches[b], len(edges) // 2)
        num_stitches[b] = n
        chosen = rng.choice(edges, size=2 * n, replace=False)
        stitches[b, :, :n] = chosen.reshape(2, -1)
        free.reshape(B, -1)[b, chosen] = False
    return dict(gt, stitches=stitches, num_stitches=num_stitches.astype(np.int32),
                free_edges_mask=free, empty_panels_mask=gt['num_edges'] == 0)


@pytest.mark.parametrize('config,epoch', [
    (dict(LOSS, panel_order_inariant_loss=True), 0),
    (dict(LOSS, panel_origin_invariant_loss=True), 0),
    (dict(LOSS, loss_components=['shape', 'stitch']), 40),
    (dict(LOSS, quality_components=['stitch']), 40),
], ids=['order_matching', 'origin_matching', 'stitch_loss', 'stitch_quality'])
def test_unported_loss_terms_raise(rng, loss_inputs, config, epoch):
    """The terms this test once found unported, each on its own over
    att.yaml's loss section, against the JAX loss on identical inputs:
    panel-order matching, loop-origin matching, the stitch-tag loss (from
    epoch_with_stitches only) and stitch precision/recall."""
    preds, gt = loss_inputs
    gt = _with_stitches(rng, gt)
    j_loss, j_terms, j_flag = JaxComposedPatternLoss(DATA, config)(
        _jax(preds), _jax(gt), epoch=epoch)
    t_loss, t_terms, t_flag = ComposedPatternLoss(DATA, config)(
        _torch(preds), _torch(gt), epoch=epoch)
    assert sorted(t_terms) == sorted(j_terms)
    assert t_flag == j_flag
    _close(t_loss, j_loss)
    for key in j_terms:
        _close(t_terms[key], j_terms[key], msg=key)
    if 'stitch' in config['loss_components']:
        assert 'stitch_neg_loss' in t_terms
        before, terms, _ = ComposedPatternLoss(DATA, config)(_torch(preds), _torch(gt),
                                                              epoch=39)
        assert 'stitch_neg_loss' not in terms and float(before) < float(t_loss)


def test_onecycle_schedule_matches_optax():
    ours = cosine_onecycle_schedule(50, 2e-3)
    theirs = optax.cosine_onecycle_schedule(transition_steps=50, peak_value=2e-3,
                                            pct_start=0.3, div_factor=25.0,
                                            final_div_factor=1e4)
    steps = range(52)
    np.testing.assert_allclose([ours(s) for s in steps], [float(theirs(s)) for s in steps],
                               rtol=1e-6)


def test_loss_phases_match_jax():
    jt = JaxTrainer.__new__(JaxTrainer)
    for config in (LOSS, dict(LOSS, epoch_with_order_matching=5, panel_order_inariant_loss=True)):
        for epoch in (0, 4, 5, 39, 40, 300):
            phase = phase_of(config, epoch)
            assert phase == jt._phase_of(config, epoch)
            assert canonical_epoch(config, *phase) == JaxTrainer._canonical_epoch(config, *phase)


def test_lstm_random_states_from_a_generator():
    decoder = LSTMDecoderModule(8, 250, 8, n_layers=3, out_len=4,
                                state_init='kaiming_normal_').train()
    states = decoder.initial_states(690, 'cpu', torch.Generator().manual_seed(0))
    assert len(states) == 3
    drawn = torch.stack([s for pair in states for s in pair])
    # std sqrt(2 / (batch * hidden)): 3.4e-3 here; 6 x 690 x 250 draws put
    # the sample std within 1% of it
    np.testing.assert_allclose(drawn.std().item(), (2.0 / (690 * 250)) ** 0.5, rtol=1e-2)
    again = decoder.initial_states(690, 'cpu', torch.Generator().manual_seed(0))
    assert torch.equal(states[2][1], again[2][1])
    assert not torch.equal(states[0][0], states[0][1])       # h and c are separate draws
    zeros = decoder.initial_states(690, 'cpu')                # no generator: zeros
    assert all(not s.any() for pair in zeros for s in pair)
    decoder.eval()                    # eval draws too, as the JAX eval step does
    in_eval = decoder.initial_states(690, 'cpu', torch.Generator().manual_seed(0))
    assert all(torch.equal(s, t) for pair, again_pair in zip(in_eval, states)
               for s, t in zip(pair, again_pair))
    zeros = decoder.initial_states(4, 'cpu')                  # eval, no generator: zeros
    assert all(not s.any() for pair in zeros for s in pair)


def test_lstm_dropout_off_is_unchanged():
    """Eval mode, or a rate of 0, runs the LSTM as it runs without dropout;
    in train mode the masks come from the generator, after the states."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(6, 8, generator=gen)
    plain = LSTMDecoderModule(8, 16, 5, n_layers=3, out_len=4, state_init='')
    init_weights(plain, 0)
    dropped = LSTMDecoderModule(8, 16, 5, n_layers=3, out_len=4, state_init='', dropout=0.4)
    dropped.load_state_dict(plain.state_dict())
    with torch.no_grad():
        reference = plain.eval()(x)
        assert torch.equal(dropped.eval()(x), reference)
        assert torch.equal(plain.train()(x, generator=torch.Generator().manual_seed(2)),
                           reference)
        drawn = dropped.train()(x, generator=torch.Generator().manual_seed(2))
        again = dropped(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(drawn, again) and not torch.equal(drawn, reference)


@pytest.mark.parametrize('rate', [0.1, 0.5])
def test_inverted_dropout_keeps_and_scales(rate):
    """flax's train-mode Dropout: the kept share is within 3 sigma of
    1 - rate, a kept element is scaled by exactly 1 / (1 - rate)."""
    from garment_pattern_estimation_torch.models.blocks import inverted_dropout

    x = torch.randn(400, 250, generator=torch.Generator().manual_seed(0))
    out = inverted_dropout(x, rate, torch.Generator().manual_seed(3))
    kept = out != 0
    n = x.numel()
    share = kept.float().mean().item()
    assert abs(share - (1 - rate)) <= 3 * ((rate * (1 - rate) / n) ** 0.5)
    assert torch.equal(out[kept], x[kept] / (1.0 - rate))


def _batches(rng, count):
    return [{'features': rng.normal(size=(B, N, 3)).astype(np.float32),
             'ground_truth': _ground_truth(rng)} for _ in range(count)]


@pytest.fixture(scope='module')
def training_runs():
    """Four Adam steps (two epochs of two batches) from the same weights in
    both frameworks, with the step-0 gradients and running statistics."""
    rng = np.random.default_rng(11)
    batches = _batches(rng, STEPS_PER_EPOCH)
    jax_model = jax_build_model('GarmentSegmentPattern3D', DATA, NN, LOSS, use_pallas=True)
    variables = jax.tree_util.tree_map(np.asarray, jax_model.init_variables(
        jax.random.PRNGKey(0), jnp.asarray(batches[0]['features'])))

    jt = JaxTrainer.__new__(JaxTrainer)
    jt.setup = dict(SETUP)
    tx = jt._make_optimizer(STEPS_PER_EPOCH)

    @jax.jit
    def jax_step(params, stats, opt_state, batch):
        def loss_fn(p):
            preds, mutated = jax_model.module.apply(
                {'params': p, 'batch_stats': stats}, batch['features'], train=True,
                mutable=['batch_stats'])
            loss, _, _ = jax_model.loss(preds, batch['ground_truth'], epoch=0)
            return loss, mutated['batch_stats']
        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, new_opt = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, new_opt, loss, grads

    model = build_model('GarmentSegmentPattern3D', DATA, NN, LOSS, device='cpu')
    model.module.load_state_dict(state_dict_from_flax(variables))
    trainer = Trainer(SETUP, device='cpu')
    trainer.make_optimizer(model, STEPS_PER_EPOCH)

    params, stats = variables['params'], variables['batch_stats']
    opt_state = tx.init(params)
    jax_losses, torch_losses, first = [], [], {}
    for epoch in range(SETUP['epochs']):
        for batch in batches:
            params, stats, opt_state, loss, grads = jax_step(
                params, stats, opt_state, jax.tree_util.tree_map(jnp.asarray, batch))
            jax_losses.append(float(loss))
            tbatch = {'features': torch.from_numpy(batch['features']),
                      'ground_truth': _torch(batch['ground_truth'])}
            loss, terms = trainer.train_step(model, tbatch, epoch)
            torch_losses.append(float(loss))
            if not first:
                # step 0: the gradients stay on the parameters after the update
                stats_np = jax.tree_util.tree_map(np.asarray, stats)
                first['jax_grads'] = state_dict_from_flax(
                    {'params': jax.tree_util.tree_map(np.asarray, grads),
                     'batch_stats': stats_np})
                first['jax_stats'] = state_dict_from_flax(
                    {'params': variables['params'], 'batch_stats': stats_np})
                first['torch_grads'] = {n: p.grad.clone()
                                        for n, p in model.module.named_parameters()}
                first['torch_stats'] = {k: v.clone() for k, v in
                                        model.module.state_dict().items() if 'running' in k}
                first['terms'] = terms
    return jax_losses, torch_losses, first


def test_train_step_loss_matches_jax(training_runs):
    jax_losses, torch_losses, first = training_runs
    np.testing.assert_allclose(torch_losses[0], jax_losses[0], rtol=1e-4)
    assert {'pattern_loss', 'loop_loss', 'num_panels_accuracy'} <= set(first['terms'])


def test_train_step_gradients_match_jax(training_runs):
    _, _, first = training_runs
    assert set(first['torch_grads']) == {k for k in first['jax_grads'] if 'running' not in k
                                         and 'num_batches' not in k}
    for name, grad in first['torch_grads'].items():
        ref = first['jax_grads'][name].numpy()
        scale = float(np.abs(ref).max())
        assert scale > 0, name
        assert np.abs(grad.numpy() - ref).max() <= 1e-3 * scale, name


def test_train_step_running_stats_match_jax(training_runs):
    _, _, first = training_runs
    assert len(first['torch_stats']) == 2 * 3 * 3      # 2 conv MLPs + attention MLP, 3 BNs
    for name, value in first['torch_stats'].items():
        ref = first['jax_stats'][name].numpy()
        assert np.abs(value.numpy() - ref).max() <= 1e-5 * float(np.abs(ref).max()), name


def test_training_trajectory_matches_jax(training_runs):
    jax_losses, torch_losses, _ = training_runs
    assert len(torch_losses) == 4
    np.testing.assert_allclose(torch_losses, jax_losses, rtol=5e-3)


# configs/att.yaml's model widths; a small cloud keeps the JAX fused Pallas
# kernel's interpret mode quick
ATT_NN = {'panel_encoding_size': 250, 'panel_hidden_size': 250, 'panel_n_layers': 3,
          'EConv_hidden': 200, 'EConv_feature': 150, 'EConv_hidden_depth': 2,
          'k_neighbors': 5, 'conv_depth': 2, 'skip_connections': True,
          'global_pool': 'mean', 'local_attention': True, 'lstm_init': 'kaiming_normal_'}
ATT_DATA = dict(DATA_CONFIG)
EVAL_POINTS = 64


class _RecordingLoss:
    """A loss that also returns the predictions it was given, under
    'pred.<key>' in its dict, so a jitted step hands them back."""

    def __init__(self, loss):
        self.loss, self.config = loss, loss.config

    def __call__(self, preds, gt, **kwargs):
        loss, terms, extra = self.loss(preds, gt, **kwargs)
        return loss, dict(terms, **{f'pred.{k}': v for k, v in preds.items()}), extra


def test_eval_step_with_drawn_states_matches_jax(monkeypatch):
    """The eval step draws the LSTM decoder's initial states when it is
    given a source of randomness, on both sides: the port's
    `Trainer.eval_step(..., generator)` and the JAX trainer's
    `_eval_step_fn` (its 'recurrent_init' rng). The port's drawn states are
    injected into the JAX model's `_init_states`, so both decode from the
    same states; outlines, rotations, translations and the loss agree to
    the bars of test_torch_model.py (1e-2 of each output's largest
    magnitude at most, 1e-4 on average: bf16 truncation flips in the edge
    MLP) and 1e-4 relative. Without a generator the port decodes from zeros,
    and its outlines differ."""
    P_att, L_att = ATT_DATA['max_pattern_len'], ATT_DATA['max_panel_len']
    rng = np.random.default_rng(13)
    x = rng.normal(size=(B, EVAL_POINTS, 3)).astype(np.float32)
    gt = _ground_truth(rng, B, P_att, L_att, EVAL_POINTS)
    jax_model = jax_build_model('GarmentSegmentPattern3D', ATT_DATA, ATT_NN, LOSS,
                                use_pallas=True)
    variables = jax.tree_util.tree_map(np.asarray, jax_model.init_variables(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    model = build_model('GarmentSegmentPattern3D', ATT_DATA, ATT_NN, LOSS, device='cpu')
    model.module.load_state_dict(state_dict_from_flax(variables))

    drawn = []
    draw = LSTMDecoderModule.initial_states

    def recording(self, *args, **kwargs):
        drawn.append(draw(self, *args, **kwargs))
        return drawn[-1]

    monkeypatch.setattr(LSTMDecoderModule, 'initial_states', recording)
    recorded = copy.copy(model)
    recorded.loss = _RecordingLoss(model.loss)
    trainer = Trainer(SETUP, device='cpu')
    batch = {'features': torch.from_numpy(x), 'ground_truth': _torch(gt)}
    loss, terms = trainer.eval_step(recorded, batch, epoch=0,
                                    generator=torch.Generator().manual_seed(5))
    assert len(drawn) == 1 and len(drawn[0]) == ATT_NN['panel_n_layers']
    std = (2.0 / (B * P_att * ATT_NN['panel_hidden_size'])) ** 0.5
    states = torch.stack([s for pair in drawn[0] for s in pair])
    assert states.abs().min() > 0
    np.testing.assert_allclose(states.std().item(), std, rtol=0.1)

    injected = []

    def inject(self, module, batch_size, n_layers, hidden, with_cell=True):
        assert module.has_rng('recurrent_init')
        assert (batch_size, n_layers, hidden) == tuple(drawn[0][0][0].shape[:1]) + (
            ATT_NN['panel_n_layers'], ATT_NN['panel_hidden_size'])
        injected.append(module.name)
        return [(jnp.asarray(h.numpy()), jnp.asarray(c.numpy())) for h, c in drawn[0]]

    monkeypatch.setattr(jax_blocks._StateInitMixin, '_init_states', inject)
    jt = JaxTrainer.__new__(JaxTrainer)
    jt._step_cache = {}
    jax_recorded = copy.copy(jax_model)
    jax_recorded.loss = _RecordingLoss(jax_model.loss)
    step = jt._eval_step_fn(jax_recorded, phase_of(LOSS, 0), B)
    jax_loss, jax_terms = step(variables['params'], variables['batch_stats'],
                               {'features': jnp.asarray(x), 'ground_truth': _jax(gt)},
                               jax.random.PRNGKey(7))
    assert len(injected) == 1
    for key in ('outlines', 'rotations', 'translations'):
        ours, ref = terms[f'pred.{key}'].numpy(), np.asarray(jax_terms[f'pred.{key}'])
        assert ours.shape == ref.shape
        scale = float(np.abs(ref).max())
        diff = np.abs(ours - ref)
        assert diff.max() <= 1e-2 * scale, (key, diff.max(), scale)
        assert diff.mean() <= 1e-4 * scale, (key, diff.mean(), scale)
    np.testing.assert_allclose(float(loss), float(jax_loss), rtol=1e-4)

    _, zero_terms = trainer.eval_step(recorded, batch, epoch=0)
    assert not any(s.any() for pair in drawn[-1] for s in pair)
    assert not torch.allclose(zero_terms['pred.outlines'], terms['pred.outlines'])
