"""The port's EdgeConv training paths past the knn_gather kernels against the
JAX package's: the chunked rematerialized sweeps
(`ops.edgeconv_train.chunked_edgeconv_train`, all three schedules and
aggregations), the `EdgeConv` layer with chunking forced, the unfused branch
past 2048 points, the eval `edge_pair` form, the auto-chunk rule, the NN
config knobs, and a 3-step training trajectory with every conv layer
chunked.

The JAX side runs with use_pallas=True, so its kNN is `knn_pallas` in
interpret mode (the direct kernel for C <= 16, `_knn_kernel` beyond); the
port runs its plain versions. Weights cross through `models.flax_import`.

Tolerances and their reasons:
  * sweeps on the same ids and weights: outputs and statistics within 1e-5
    of their largest magnitude (f32 sums in another order, scaled up by
    the BatchNorm of channels with a small variance); their gradients,
    through the statistics too, within 2e-4 of each one's largest element;
  * the layer: output and running statistics within 1e-5 of their scale,
    parameter and input gradients within 2e-4 relative (the bar of
    tests/test_edgeconv_train.py), 1e-6 absolute;
  * the trajectory: as tests/test_torch_train.py holds it (step 0 loss 1e-4
    relative, gradients 1e-3 of each parameter's scale, running statistics
    1e-5 of each buffer's scale, the losses 5e-3 relative).
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import garment_pattern_estimation_tpu.models.blocks as jax_blocks
from garment_pattern_estimation_tpu.models import build_model as jax_build_model
from garment_pattern_estimation_tpu.ops.edgeconv_train import (
    _default_chunk as jax_default_chunk, chunked_edgeconv_train as jax_chunked)
from garment_pattern_estimation_tpu.train.trainer import Trainer as JaxTrainer
from garment_pattern_estimation_torch.models import blocks, build_model, state_dict_from_flax
from garment_pattern_estimation_torch.models.flax_import import _mlp
from garment_pattern_estimation_torch.ops import edgeconv_train, knn
from garment_pattern_estimation_torch.train import Trainer
from test_torch_train import DATA, LOSS, NN, SETUP, _batches, _torch

torch.set_num_threads(1)

MODES = ('chunked', 'fused_final', 'streamed')


def _mlp_variables(rng, c, widths):
    """Seeded Dense/BatchNorm params and running statistics, BN scales of
    both signs (the max/min branch of 'fused_final')."""
    params, stats = {}, {}
    for i, (fan_in, fan_out) in enumerate(zip([2 * c, *widths[:-1]], widths)):
        params[f'Dense_{i}'] = {
            'kernel': (rng.normal(size=(fan_in, fan_out)) / fan_in ** 0.5).astype(np.float32),
            'bias': (rng.normal(size=fan_out) * 0.1).astype(np.float32)}
        signs = np.where(np.arange(fan_out) % 2 == 0, 1.0, -1.0)
        params[f'BatchNorm_{i}'] = {
            'scale': (rng.uniform(0.5, 1.5, fan_out) * signs).astype(np.float32),
            'bias': rng.normal(size=fan_out).astype(np.float32)}
        stats[f'BatchNorm_{i}'] = {
            'mean': (rng.normal(size=fan_out) * 0.1).astype(np.float32),
            'var': rng.uniform(0.5, 2.0, fan_out).astype(np.float32)}
    return params, stats


def _port_layer(c, widths, k, params, stats, **kwargs):
    layer = blocks.EdgeConv(c, widths, k=k, **kwargs)
    sd = {}
    _mlp(sd, 'nn', params, stats)
    layer.load_state_dict(sd)
    return layer


def _close(ours, theirs, rtol=1e-5, atol=1e-6, msg=''):
    np.testing.assert_allclose(np.asarray(ours, np.float64), np.asarray(theirs, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


def _close_to_scale(ours, theirs, rel, msg=''):
    theirs = np.asarray(theirs, np.float64)
    scale = float(np.abs(theirs).max())
    assert np.abs(np.asarray(ours, np.float64) - theirs).max() <= rel * scale, msg


@pytest.mark.parametrize('aggr', ['max', 'mean', 'sum'])
@pytest.mark.parametrize('mode', MODES)
@pytest.mark.parametrize('chunk', [7, 16])
def test_sweeps_match_jax(rng, mode, aggr, chunk):
    """N = 40 in chunks of 7 or 16: the last chunk is padded."""
    B, N, C, K, widths = 2, 40, 5, 4, [11, 9, 7]
    params, stats = _mlp_variables(rng, C, widths)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = knn.knn(torch.from_numpy(x), K)
    ref_out, ref_stats = jax_chunked(jnp.asarray(x), jnp.asarray(idx.numpy()), params,
                                     chunk=chunk, aggr=aggr, mode=mode)
    mlp = _port_layer(C, widths, K, params, stats).nn
    out, st = edgeconv_train.chunked_edgeconv_train(torch.from_numpy(x), idx, mlp,
                                                    chunk=chunk, aggr=aggr, mode=mode)
    assert out.shape == (B, N, widths[-1])
    _close_to_scale(out.detach(), ref_out, 1e-5)
    for (m, v), (rm, rv) in zip(st, ref_stats):
        _close_to_scale(m.detach(), rm, 1e-5)
        _close_to_scale(v.detach(), rv, 1e-5)


@pytest.mark.parametrize('mode', MODES)
def test_sweep_gradients_match_jax(rng, mode):
    """Gradients of a loss that reads the output and the statistics, so the
    BatchNorm coupling terms are held too."""
    B, N, C, K, widths = 2, 23, 5, 4, [11, 9, 7]
    params, stats = _mlp_variables(rng, C, widths)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    idx = knn.knn(torch.from_numpy(x), K)

    def jax_loss(p, pts):
        out, st = jax_chunked(pts, jnp.asarray(idx.numpy()), p, chunk=7, mode=mode)
        return jnp.sum(out ** 2) / out.size + 0.01 * sum(jnp.sum(m) + jnp.sum(v) for m, v in st)

    ref_gp, ref_gx = jax.grad(jax_loss, argnums=(0, 1))(params, jnp.asarray(x))
    mlp = _port_layer(C, widths, K, params, stats).nn
    xt = torch.from_numpy(x).requires_grad_(True)
    out, st = edgeconv_train.chunked_edgeconv_train(xt, idx, mlp, chunk=7, mode=mode)
    loss = torch.sum(out ** 2) / out.numel() + 0.01 * sum(m.sum() + v.sum() for m, v in st)
    loss.backward()
    _close_to_scale(xt.grad, ref_gx, 2e-4)
    for i, (linear, _, bn) in enumerate(mlp):
        _close_to_scale(linear.weight.grad.t(), ref_gp[f'Dense_{i}']['kernel'], 2e-4)
        _close_to_scale(linear.bias.grad, ref_gp[f'Dense_{i}']['bias'], 2e-4)
        _close_to_scale(bn.weight.grad, ref_gp[f'BatchNorm_{i}']['scale'], 2e-4)
        _close_to_scale(bn.bias.grad, ref_gp[f'BatchNorm_{i}']['bias'], 2e-4)


def test_default_chunk_and_unported_options_match_jax():
    for shape in ((128, 10000, 5, 200), (2, 128, 5, 64), (4096, 100000, 40, 4096)):
        assert edgeconv_train._default_chunk(*shape) == jax_default_chunk(*shape)
    mlp = blocks.MLP([6, 4])
    x, idx = torch.zeros(1, 8, 3), torch.zeros(1, 8, 2, dtype=torch.int64)
    with pytest.raises(ValueError, match='unknown EdgeConv train mode'):
        edgeconv_train.chunked_edgeconv_train(x, idx, mlp, mode='bogus')
    with pytest.raises(ValueError, match='compute_dtype'):
        edgeconv_train.chunked_edgeconv_train(x, idx, mlp, compute_dtype='float16')


def _jax_layer_run(layer, params, stats, x):
    """Output, updated batch statistics and (params, input) gradients of
    sum(out^2) / size."""
    variables = {'params': {'MLP_0': params}, 'batch_stats': {'MLP_0': stats}}
    out, mutated = layer.apply(variables, jnp.asarray(x), train=True, mutable=['batch_stats'])

    def loss(p, pts):
        o, _ = layer.apply({'params': p, 'batch_stats': variables['batch_stats']}, pts,
                           train=True, mutable=['batch_stats'])
        return jnp.sum(o ** 2) / o.size

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables['params'], jnp.asarray(x))
    return out, mutated['batch_stats']['MLP_0'], gp['MLP_0'], gx


def _assert_layer_matches(layer, x, ref):
    ref_out, ref_stats, ref_gp, ref_gx = ref
    xt = torch.from_numpy(x).requires_grad_(True)
    out = layer.train()(xt)
    (torch.sum(out ** 2) / out.numel()).backward()
    _close_to_scale(out.detach(), ref_out, 1e-5, 'output')
    for i, (linear, _, bn) in enumerate(layer.nn):
        _close_to_scale(bn.running_mean, ref_stats[f'BatchNorm_{i}']['mean'], 1e-5, 'mean')
        _close_to_scale(bn.running_var, ref_stats[f'BatchNorm_{i}']['var'], 1e-5, 'var')
        _close(linear.weight.grad.t(), ref_gp[f'Dense_{i}']['kernel'], rtol=2e-4)
        _close(linear.bias.grad, ref_gp[f'Dense_{i}']['bias'], rtol=2e-4)
        _close(bn.weight.grad, ref_gp[f'BatchNorm_{i}']['scale'], rtol=2e-4)
        _close(bn.bias.grad, ref_gp[f'BatchNorm_{i}']['bias'], rtol=2e-4)
    _close(xt.grad, ref_gx, rtol=2e-4)


@pytest.mark.parametrize('C,mode', [(6, 'fused_final'), (24, 'fused_final'),
                                    (24, 'chunked'), (6, 'streamed')])
def test_chunked_layer_matches_jax(rng, C, mode):
    """C = 24 takes the wide-D kNN on both sides (`_knn_kernel` there)."""
    B, N, K, widths = 3, 40, 4, [16, 12]
    params, stats = _mlp_variables(rng, C, widths)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    ref = _jax_layer_run(jax_blocks.EdgeConv(widths, k=K, use_pallas=True, train_chunked=True,
                                             train_chunk_size=16, train_mode=mode),
                         params, stats, x)
    before = dict(knn.launches)
    layer = _port_layer(C, widths, K, params, stats, train_chunked=True, train_chunk_size=16,
                        train_mode=mode)
    _assert_layer_matches(layer, x, ref)
    assert knn.launches == before            # the CPU takes the plain kNN


def test_unfused_train_past_2048_points_matches_jax(rng):
    """B = 1, N = 2100 > 2048 unchunked: the standalone kNN, the gather and
    the edge MLP on (B, N, k, C), on both sides."""
    C, K, widths = 3, 5, [8, 6]
    params, stats = _mlp_variables(rng, C, widths)
    x = rng.normal(size=(1, 2100, C)).astype(np.float32)
    ref = _jax_layer_run(jax_blocks.EdgeConv(widths, k=K, use_pallas=True,
                                             train_chunked=False), params, stats, x)
    layer = _port_layer(C, widths, K, params, stats)
    assert not layer.chunked(*x.shape)
    _assert_layer_matches(layer, x, ref)


@pytest.mark.parametrize('C', [6, 24])
def test_eval_edge_pair_form_matches_jax(rng, monkeypatch, C):
    """The unfused eval branch (the one past 16384 points), reached at
    N = 40 by turning the fused and knn_gather predicates off on both
    sides: folded running statistics, the factored first layer."""
    K, widths = 4, [16, 12]
    params, stats = _mlp_variables(rng, C, widths)
    x = rng.normal(size=(2, 40, C)).astype(np.float32)
    monkeypatch.setattr(jax_blocks, 'fused_edgeconv_supported', lambda *args: False)
    monkeypatch.setattr(jax_blocks, 'knn_gather_supported', lambda *args: False)
    monkeypatch.setattr(blocks, 'fused_edgeconv_supported', lambda *args: False)
    monkeypatch.setattr(blocks, 'knn_gather_supported', lambda *args: False)
    ref = jax_blocks.EdgeConv(widths, k=K, use_pallas=True).apply(
        {'params': {'MLP_0': params}, 'batch_stats': {'MLP_0': stats}}, jnp.asarray(x),
        train=False)
    layer = _port_layer(C, widths, K, params, stats).eval()
    with torch.no_grad():
        out = layer(torch.from_numpy(x))
    _close_to_scale(out, ref, 1e-5)


@pytest.mark.parametrize('C,threshold', [(6, 20479), (6, 20480), (24, 30719), (24, 30720)])
def test_auto_rule_picks_chunked_where_jax_does(rng, monkeypatch, C, threshold):
    """B N k max(C, widths) 4 bytes is 20480 at C = 6 and 30720 at C = 24:
    each side chunks past the threshold and not at it."""
    B, N, K, widths = 2, 40, 4, [16, 12]
    params, stats = _mlp_variables(rng, C, widths)
    x = rng.normal(size=(B, N, C)).astype(np.float32)
    calls = {'jax': 0, 'port': 0}

    def spy(side, fn):
        def wrapped(*args, **kwargs):
            calls[side] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(jax_blocks.EdgeConv, '_CHUNK_TRAIN_BYTES', threshold)
    monkeypatch.setattr(blocks.EdgeConv, '_CHUNK_TRAIN_BYTES', threshold)
    monkeypatch.setattr(jax_blocks, 'chunked_edgeconv_train',
                        spy('jax', jax_blocks.chunked_edgeconv_train))
    monkeypatch.setattr(blocks, 'chunked_edgeconv_train',
                        spy('port', blocks.chunked_edgeconv_train))
    jax_blocks.EdgeConv(widths, k=K, use_pallas=True).apply(
        {'params': {'MLP_0': params}, 'batch_stats': {'MLP_0': stats}}, jnp.asarray(x),
        train=True, mutable=['batch_stats'])
    _port_layer(C, widths, K, params, stats).train()(torch.from_numpy(x))
    assert calls['jax'] == calls['port'] == (1 if threshold < B * N * K * max(C, 16) * 4 else 0)


def test_nn_config_knobs_reach_every_layer():
    nn_config = dict(NN, conv_depth=3, edgeconv_train_chunk=384, edgeconv_train_mode='streamed')
    model = build_model('GarmentSegmentPattern3D', DATA, nn_config, LOSS, device='cpu')
    convs = model.module.feature_extractor.conv_layers
    assert len(convs) == 3
    for conv in convs:
        assert conv.train_chunk_size == 384 and conv.train_mode == 'streamed'
        assert conv.train_chunked is None
    assert model.config['edgeconv_train_chunk'] == 384
    assert model.config['edgeconv_train_mode'] == 'streamed'
    default = build_model('GarmentSegmentPattern3D', DATA, NN, LOSS, device='cpu')
    assert all(c.train_chunk_size is None and c.train_mode == 'fused_final'
               for c in default.module.feature_extractor.conv_layers)
    with pytest.raises(ValueError, match='unknown EdgeConv train mode'):
        build_model('GarmentSegmentPattern3D', DATA,
                    dict(NN, edgeconv_train_mode='bogus'), LOSS, device='cpu')


@pytest.fixture(scope='module')
def chunked_training_runs():
    """Three Adam steps on three batches from the same weights in both
    frameworks, every conv layer chunked (the byte threshold at 0) in
    chunks of 48 of the 128 points; the step-0 gradients and running
    statistics."""
    steps = 3
    nn_config = dict(NN, edgeconv_train_chunk=48)
    rng = np.random.default_rng(12)
    batches = _batches(rng, steps)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_blocks.EdgeConv, '_CHUNK_TRAIN_BYTES', 0)
        mp.setattr(blocks.EdgeConv, '_CHUNK_TRAIN_BYTES', 0)
        jax_model = jax_build_model('GarmentSegmentPattern3D', DATA, nn_config, LOSS,
                                    use_pallas=True)
        variables = jax.tree_util.tree_map(np.asarray, jax_model.init_variables(
            jax.random.PRNGKey(1), jnp.asarray(batches[0]['features'])))
        jt = JaxTrainer.__new__(JaxTrainer)
        jt.setup = dict(SETUP)
        tx = jt._make_optimizer(steps)

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

        model = build_model('GarmentSegmentPattern3D', DATA, nn_config, LOSS, device='cpu')
        model.module.load_state_dict(state_dict_from_flax(variables))
        trainer = Trainer(SETUP, device='cpu')
        trainer.make_optimizer(model, steps)
        calls = []
        mp.setattr(blocks, 'chunked_edgeconv_train',
                   lambda *a, **kw: calls.append(1) or edgeconv_train.chunked_edgeconv_train(
                       *a, **kw))

        params, stats = variables['params'], variables['batch_stats']
        opt_state = tx.init(params)
        jax_losses, torch_losses, first = [], [], {}
        for batch in batches:
            params, stats, opt_state, loss, grads = jax_step(
                params, stats, opt_state, jax.tree_util.tree_map(jnp.asarray, batch))
            jax_losses.append(float(loss))
            tbatch = {'features': torch.from_numpy(batch['features']),
                      'ground_truth': _torch(batch['ground_truth'])}
            loss, _ = trainer.train_step(model, tbatch, 0)
            torch_losses.append(float(loss))
            if not first:
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
    first['chunked_calls'] = len(calls)
    return jax_losses, torch_losses, first


def test_chunked_trajectory_loss_matches_jax(chunked_training_runs):
    jax_losses, torch_losses, first = chunked_training_runs
    assert first['chunked_calls'] == 2 * 3          # both conv layers, every step
    np.testing.assert_allclose(torch_losses[0], jax_losses[0], rtol=1e-4)
    np.testing.assert_allclose(torch_losses, jax_losses, rtol=5e-3)


def test_chunked_trajectory_gradients_match_jax(chunked_training_runs):
    _, _, first = chunked_training_runs
    for name, grad in first['torch_grads'].items():
        ref = first['jax_grads'][name].numpy()
        scale = float(np.abs(ref).max())
        assert scale > 0, name
        assert np.abs(grad.numpy() - ref).max() <= 1e-3 * scale, name


def test_chunked_trajectory_running_stats_match_jax(chunked_training_runs):
    _, _, first = chunked_training_runs
    assert len(first['torch_stats']) == 2 * 3 * 3
    for name, value in first['torch_stats'].items():
        ref = first['jax_stats'][name].numpy()
        assert np.abs(value.numpy() - ref).max() <= 1e-5 * float(np.abs(ref).max()), name
