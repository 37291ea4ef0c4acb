"""The port's attention model against the JAX package's eval forward, on the
same weights carried across by `state_dict_from_flax`.

The JAX model is built with use_pallas=True, so on the CPU its EdgeConv
layers run the fused Pallas kernel in interpret mode; the port runs its
plain fused layer. Widths are cut (EConv 16/24, panel hidden 32, 2 LSTM
layers); EConv_feature 24 > 16 keeps conv1 on the wide-C variant. BN
statistics are perturbed so every fold does work.

Tolerances, relative to each output's largest magnitude: 1e-2 at most,
1e-4 on average. The edge MLP truncates activations to bf16 before every
layer, so a 1-ulp difference in f32 sum order between torch and XLA can
flip a truncation and move that element by up to 2^-8 of itself; the
attention weights inherit it through sparsemax.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import DATA_CONFIG, LOSS_CONFIG
from garment_pattern_estimation_tpu.models import build_model as jax_build_model
from garment_pattern_estimation_torch.models import build_model, state_dict_from_flax

torch.set_num_threads(1)

DATA = dict(DATA_CONFIG, max_panel_len=5, max_pattern_len=6)
NN = {'panel_encoding_size': 32, 'panel_hidden_size': 32, 'panel_n_layers': 2,
      'EConv_hidden': 16, 'EConv_feature': 24, 'EConv_hidden_depth': 2,
      'k_neighbors': 5, 'conv_depth': 2, 'skip_connections': True,
      'global_pool': 'mean', 'local_attention': True}
KEYS = ('outlines', 'rotations', 'translations', 'stitch_tags',
        'free_edges_mask', 'att_weights')


def shared_model(seed=0, n_points=128, nn_config=NN):
    """(JAX model, its variables as numpy, port model, input cloud)."""
    rng = np.random.default_rng(seed)
    jax_model = jax_build_model('GarmentSegmentPattern3D', DATA, nn_config, LOSS_CONFIG,
                                use_pallas=True)
    x = rng.normal(size=(2, n_points, 3)).astype(np.float32)
    variables = jax.tree_util.tree_map(
        np.asarray, jax_model.init_variables(jax.random.PRNGKey(seed), jnp.asarray(x)))

    def perturb(tree):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = perturb(value)
            elif key == 'var':
                out[key] = value + rng.uniform(0.1, 0.5, value.shape).astype(np.float32)
            else:
                out[key] = value + 0.1 * rng.normal(size=value.shape).astype(np.float32)
        return out

    variables = {'params': variables['params'],
                 'batch_stats': perturb(variables['batch_stats'])}
    model = build_model('GarmentSegmentPattern3D', DATA, nn_config, device='cpu')
    model.module.load_state_dict(state_dict_from_flax(variables))
    return jax_model, variables, model, x


def assert_close_to_scale(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = float(np.abs(ref).max())
    diff = np.abs(out - ref)
    assert diff.max() <= 1e-2 * scale, (diff.max(), scale)
    assert diff.mean() <= 1e-4 * scale, (diff.mean(), scale)


@pytest.fixture(scope='module')
def forwards():
    jax_model, variables, model, x = shared_model()
    ref = jax_model.module.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    return {k: np.asarray(v) for k, v in ref.items()}, \
        {k: v.numpy() for k, v in out.items()}, model, variables


def test_same_output_keys(forwards):
    ref, out, _, _ = forwards
    assert sorted(out) == sorted(ref) == sorted(KEYS)


@pytest.mark.parametrize('key', KEYS)
def test_forward_matches_jax(forwards, key):
    ref, out, _, _ = forwards
    assert_close_to_scale(out[key], ref[key])


def test_state_dict_is_complete(forwards):
    """Every port parameter and buffer comes from the flax tree, under the
    reference state-dict names."""
    _, _, model, variables = forwards
    sd = state_dict_from_flax(variables)
    model_keys = set(model.module.state_dict())
    assert set(sd) == model_keys
    assert 'feature_extractor.conv_layers.1.nn.2.0.weight' in sd
    assert 'point_segment_mlp.0.1.2.running_var' in sd
    assert 'panel_decoder.lstm.weight_hh_l1' in sd
    w = variables['params']['feature_extractor']['conv0']['MLP_0']['Dense_0']['kernel']
    np.testing.assert_array_equal(
        sd['feature_extractor.conv_layers.0.nn.0.0.weight'].numpy(), w.T)


def test_global_attention_head_matches_jax():
    """local_attention False (the registry's default): the encoder pools
    globally through `feature_extractor.lin` and the attention MLP sees the
    global encoding beside each point's features."""
    nn_config = dict(NN, local_attention=False, pattern_encoding_size=16)
    jax_model, variables, model, x = shared_model(seed=3, n_points=64,
                                                   nn_config=nn_config)
    assert 'feature_extractor.lin.weight' in model.module.state_dict()
    ref = jax_model.module.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for key in KEYS:
        assert_close_to_scale(out[key].numpy(), np.asarray(ref[key]))
