"""The port's bf16 mixed-precision mode (`NN.compute_dtype: bfloat16`,
configs/att_bf16.yaml) against the JAX package's, on the CPU at small
sizes: the MLP, the chunked EdgeConv sweeps, the attention model's eval
forward in each precision setting and one training step.

The JAX side runs with use_pallas=True: on the CPU its fused EdgeConv
(eval) and knn_gather (train) are the Pallas kernels in interpret mode;
the port runs its plain versions. Weights cross through
`state_dict_from_flax`; BN statistics are perturbed so every fold works.

Bars, from the JAX package's own bf16 bars (tests/test_edgeconv_train_modes.py,
tests/test_knn_gather.py): outputs, statistics and losses within 3e-2 of
their largest magnitude; gradients with a cosine above 0.99 to JAX's. Both
sides cast at the same places, so the forward gaps are far below the bars
(measured: eval outputs 6.7e-7 at most, the loss equal, running statistics
9.2e-8, the MLP equal, the sweeps' outputs 1.1e-7 and statistics 4.7e-7).
The gradients run in bf16 through the casts and their bf16 sums round in
another order, each rounding up to 2^-8 of an element: the lowest cosine
measured is 0.9943 (a conv0 bias; single elements differ by up to 0.18 of
that parameter's largest), the sweeps' 0.9998.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import DATA_CONFIG
from garment_pattern_estimation_tpu.models import blocks as jax_blocks
from garment_pattern_estimation_tpu.models import build_model as jax_build_model
from garment_pattern_estimation_tpu.ops.edgeconv_train import (
    chunked_edgeconv_train as jax_chunked)
from garment_pattern_estimation_torch.models import blocks, build_model, state_dict_from_flax
from garment_pattern_estimation_torch.models.flax_import import _mlp
from garment_pattern_estimation_torch.ops import (
    edgeconv_train, knn, knn_gather, launches_by_variant)
from garment_pattern_estimation_torch.train import Trainer
from test_torch_train import LOSS, SETUP, _ground_truth, _torch

torch.set_num_threads(1)

BAR = 3e-2                  # outputs, statistics, losses: of their largest magnitude
COSINE = 0.99               # gradients
B, N, P, L = 2, 64, 6, 5
DATA = dict(DATA_CONFIG, max_panel_len=L, max_pattern_len=P)
# narrow widths; EConv_feature 24 > 16 keeps conv1 on the wide-C kernels
NN = {'panel_encoding_size': 32, 'panel_hidden_size': 32, 'panel_n_layers': 2,
      'EConv_hidden': 16, 'EConv_feature': 24, 'EConv_hidden_depth': 2,
      'k_neighbors': 5, 'conv_depth': 2, 'skip_connections': True,
      'global_pool': 'mean', 'local_attention': True, 'lstm_init': 'kaiming_normal_',
      'compute_dtype': 'bfloat16'}
SETTINGS = {'bf16': {}, 'f32_conv0': {'f32_conv_layers': [0]},
            'f32_attention': {'f32_attention_mlp': True}}
KEYS = ('outlines', 'rotations', 'translations', 'stitch_tags',
        'free_edges_mask', 'att_weights')


def _gap(ours, ref):
    """Largest element gap over the reference's largest magnitude."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _cosine(ours, ref):
    ours, ref = np.asarray(ours, np.float64).ravel(), np.asarray(ref, np.float64).ravel()
    return float(ours @ ref / (np.linalg.norm(ours) * np.linalg.norm(ref)))


def _perturb(rng, tree):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _perturb(rng, value)
        elif key == 'var':
            out[key] = value + rng.uniform(0.1, 0.5, value.shape).astype(np.float32)
        else:
            out[key] = value + 0.1 * rng.normal(size=value.shape).astype(np.float32)
    return out


@pytest.fixture(scope='module')
def shared():
    """Seeded flax variables of the model (every precision setting has the
    same parameters) with perturbed BN statistics, and a cloud."""
    rng = np.random.default_rng(1)
    jax_model = jax_build_model('GarmentSegmentPattern3D', DATA, NN, LOSS, use_pallas=True)
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jax_model.init_variables)(
        jax.random.PRNGKey(1), jnp.asarray(x)))
    return {'params': variables['params'],
            'batch_stats': _perturb(rng, variables['batch_stats'])}, x


def _models(nn_config, variables):
    """(JAX model, port model on the CPU with the same variables)."""
    jax_model = jax_build_model('GarmentSegmentPattern3D', DATA, nn_config, LOSS,
                                use_pallas=True)
    model = build_model('GarmentSegmentPattern3D', DATA, nn_config, LOSS, device='cpu')
    model.module.load_state_dict(state_dict_from_flax(variables))
    return jax_model, model


@pytest.mark.parametrize('setting', sorted(SETTINGS))
def test_eval_forward_matches_jax(shared, setting):
    """(a) The eval forward in each precision setting: the fused layer with
    one value chunk, the attention MLP in bf16 or f32."""
    variables, x = shared
    nn_config = dict(NN, **SETTINGS[setting])
    jax_model, model = _models(nn_config, variables)
    convs = model.module.feature_extractor.conv_layers
    expect = [None if i in nn_config.get('f32_conv_layers', ()) else torch.bfloat16
              for i in range(len(convs))]
    assert [conv.compute_dtype for conv in convs] == expect
    att_dtype = None if nn_config.get('f32_attention_mlp') else torch.bfloat16
    assert model.module.point_segment_mlp[0].compute_dtype == att_dtype
    ref = jax.jit(lambda v, pts: jax_model.module.apply(v, pts, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for key in KEYS:
        assert out[key].dtype == torch.float32, key
        gap = _gap(out[key].numpy(), np.asarray(ref[key], np.float32))
        assert gap <= BAR, (setting, key, gap)


def _states(rng, n_layers, hidden):
    std = (2.0 / (B * P * hidden)) ** 0.5
    return [tuple((rng.normal(size=(B * P, hidden)) * std).astype(np.float32)
                  for _ in range(2)) for _ in range(n_layers)]


def test_train_step_matches_jax(shared, monkeypatch):
    """(b) One train_step of the bf16 model: loss, every parameter's
    gradient and the updated running statistics, both sides decoding from
    the same injected LSTM states."""
    variables, x = shared
    jax_model, model = _models(NN, variables)
    rng = np.random.default_rng(3)
    gt = _ground_truth(rng, B, P, L, N)
    states = _states(rng, NN['panel_n_layers'], NN['panel_hidden_size'])
    monkeypatch.setattr(blocks.LSTMDecoderModule, 'initial_states',
                        lambda self, *a, **kw: [tuple(map(torch.from_numpy, s)) for s in states])
    monkeypatch.setattr(jax_blocks._StateInitMixin, '_init_states',
                        lambda self, *a, **kw: [tuple(map(jnp.asarray, s)) for s in states])

    def loss_fn(params):
        preds, mutated = jax_model.module.apply(
            {'params': params, 'batch_stats': variables['batch_stats']}, jnp.asarray(x),
            train=True, mutable=['batch_stats'])
        loss, _, _ = jax_model.loss(preds, {k: jnp.asarray(v) for k, v in gt.items()},
                                    epoch=0)
        return loss, mutated['batch_stats']

    (ref_loss, ref_stats), ref_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables['params'])
    ref_grads = state_dict_from_flax({'params': jax.tree_util.tree_map(np.asarray, ref_grads),
                                      'batch_stats': variables['batch_stats']})
    ref_stats = state_dict_from_flax({'params': variables['params'],
                                      'batch_stats': jax.tree_util.tree_map(np.asarray,
                                                                            ref_stats)})

    trainer = Trainer(SETUP, device='cpu')
    trainer.make_optimizer(model, 2)
    before = launches_by_variant(knn_gather)
    loss, _ = trainer.train_step(model, {'features': torch.from_numpy(x),
                                         'ground_truth': _torch(gt)}, epoch=0)
    assert launches_by_variant(knn_gather) == before  # the CPU takes the plain versions
    assert abs(float(loss) - float(ref_loss)) <= BAR * abs(float(ref_loss))
    for name, p in model.module.named_parameters():
        assert p.dtype == torch.float32
        cosine = _cosine(p.grad.numpy(), ref_grads[name].numpy())
        assert cosine >= COSINE, (name, cosine)
    for name, value in model.module.state_dict().items():
        if 'running' in name:
            gap = _gap(value.numpy(), ref_stats[name].numpy())
            assert gap <= BAR, (name, gap)


def _mlp_variables(rng, fan_in, widths):
    params, stats = {}, {}
    for i, (a, b) in enumerate(zip([fan_in, *widths[:-1]], widths)):
        params[f'Dense_{i}'] = {
            'kernel': (rng.normal(size=(a, b)) / a ** 0.5).astype(np.float32),
            'bias': (rng.normal(size=b) * 0.1).astype(np.float32)}
        signs = np.where(np.arange(b) % 2 == 0, 1.0, -1.0)
        params[f'BatchNorm_{i}'] = {
            'scale': (rng.uniform(0.5, 1.5, b) * signs).astype(np.float32),
            'bias': rng.normal(size=b).astype(np.float32)}
        stats[f'BatchNorm_{i}'] = {
            'mean': (rng.normal(size=b) * 0.1).astype(np.float32),
            'var': rng.uniform(0.5, 2.0, b).astype(np.float32)}
    return params, stats


def _port_mlp(fan_in, widths, params, stats):
    mlp = blocks.MLP([fan_in, *widths], compute_dtype='bfloat16')
    sd = {}
    _mlp(sd, 'm', params, stats)
    mlp.load_state_dict({k[len('m.'):]: v for k, v in sd.items()})
    return mlp


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('edge_pair', [False, True])
def test_mlp_matches_jax(rng, train, edge_pair):
    """(d) The bf16 MLP, eval (running statistics folded) and train (batch
    statistics, running averages updated), on a plain input and on the
    factored EdgeConv input (center, slot-major neighbours)."""
    C, widths = 5, [16, 16, 12]
    fan_in = 2 * C if edge_pair else 24
    params, stats = _mlp_variables(rng, fan_in, widths)
    center = rng.normal(size=(2, 30, C)).astype(np.float32)
    nbr = rng.normal(size=(2, 4, 30, C)).astype(np.float32)
    x = rng.normal(size=(60, fan_in)).astype(np.float32)
    jax_mlp = jax_blocks.MLP(widths, compute_dtype='bfloat16')
    kwargs = {'edge_pair': (jnp.asarray(center), jnp.asarray(nbr), 1)} if edge_pair else {}
    jx = None if edge_pair else jnp.asarray(x)
    res = jax_mlp.apply({'params': params, 'batch_stats': stats}, jx, train=train,
                        mutable=['batch_stats'] if train else False, **kwargs)
    ref, ref_stats = res if train else (res, None)

    mlp = _port_mlp(fan_in, widths, params, stats).train(train)
    with torch.no_grad():
        out = mlp(edge_pair=(torch.from_numpy(center), torch.from_numpy(nbr), 1)) \
            if edge_pair else mlp(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    assert _gap(out.float().numpy(), np.asarray(ref, np.float32)) <= BAR
    if train:
        for i, (_, _, bn) in enumerate(mlp):
            rs = ref_stats['batch_stats'][f'BatchNorm_{i}']
            assert _gap(bn.running_mean.numpy(), rs['mean']) <= BAR
            assert _gap(bn.running_var.numpy(), rs['var']) <= BAR


def test_mlp_eval_fold_casts_as_jax_per_layer_fold(rng):
    """The port's eval MLP folds every BN up front (`fold_mlp_bn`); JAX
    folds each into the next layer as it goes. In bf16 both cast x, the
    folded W and the folded b at each product: the outputs are equal."""
    widths = [16, 16, 12]
    params, stats = _mlp_variables(rng, 24, widths)
    x = rng.normal(size=(200, 24)).astype(np.float32)
    ref = jax_blocks.MLP(widths, compute_dtype='bfloat16').apply(
        {'params': params, 'batch_stats': stats}, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = _port_mlp(24, widths, params, stats).eval()(torch.from_numpy(x))
    np.testing.assert_array_equal(out.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize('mode', edgeconv_train.MODES)
def test_chunked_sweeps_match_jax(rng, mode):
    """(c) The bf16 chunked sweeps on the same ids and weights, chunks of
    16 over 40 points (the last padded): output and statistics, and the
    gradients of a loss that reads both."""
    Bs, Ns, C, K, widths = 2, 40, 5, 4, [11, 9, 7]
    params, stats = _mlp_variables(rng, 2 * C, widths)
    x = rng.normal(size=(Bs, Ns, C)).astype(np.float32)
    idx = knn.knn(torch.from_numpy(x), K)

    def jax_loss(p, pts):
        out, st = jax_chunked(pts, jnp.asarray(idx.numpy()), p, chunk=16, mode=mode,
                              compute_dtype='bfloat16')
        return jnp.sum(out ** 2) / out.size + 0.01 * sum(
            jnp.sum(m) + jnp.sum(v) for m, v in st), (out, st)

    (_, (ref_out, ref_st)), (ref_gp, ref_gx) = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    mlp = _port_mlp(2 * C, widths, params, stats)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, st = edgeconv_train.chunked_edgeconv_train(xt, idx, mlp, chunk=16, mode=mode,
                                                    compute_dtype='bfloat16')
    (torch.sum(out ** 2) / out.numel() + 0.01 * sum(m.sum() + v.sum() for m, v in st)).backward()
    assert out.dtype == torch.float32
    assert _gap(out.detach(), ref_out) <= BAR
    for (m, v), (rm, rv) in zip(st, ref_st):
        assert _gap(m.detach(), rm) <= BAR and _gap(v.detach(), rv) <= BAR
    assert _cosine(xt.grad, ref_gx) >= COSINE
    for i, (linear, _, bn) in enumerate(mlp):
        assert _cosine(linear.weight.grad.t(), ref_gp[f'Dense_{i}']['kernel']) >= COSINE
        assert _cosine(linear.bias.grad, ref_gp[f'Dense_{i}']['bias']) >= COSINE
        assert _cosine(bn.weight.grad, ref_gp[f'BatchNorm_{i}']['scale']) >= COSINE
        assert _cosine(bn.bias.grad, ref_gp[f'BatchNorm_{i}']['bias']) >= COSINE


def test_flax_variables_of_the_bf16_model_load(shared):
    """The bf16 JAX model keeps f32 parameters and statistics under the f32
    model's names, so `state_dict_from_flax` loads them unchanged."""
    variables, x = shared
    f32_model = jax_build_model('GarmentSegmentPattern3D', DATA,
                                {k: v for k, v in NN.items() if k != 'compute_dtype'}, LOSS,
                                use_pallas=True)
    f32_shapes = jax.eval_shape(f32_model.init_variables, jax.random.PRNGKey(0),
                                jnp.asarray(x))
    assert jax.tree_util.tree_structure(variables) == jax.tree_util.tree_structure(
        {'params': f32_shapes['params'], 'batch_stats': f32_shapes['batch_stats']})
    assert all(leaf.dtype == np.float32 for leaf in jax.tree_util.tree_leaves(variables))
    model = build_model('GarmentSegmentPattern3D', DATA, NN, LOSS, device='cpu')
    sd = state_dict_from_flax(variables)
    assert set(sd) == set(model.module.state_dict())
    model.module.load_state_dict(sd)
    assert all(p.dtype == torch.float32 for p in model.module.parameters())
