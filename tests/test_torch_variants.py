"""Both shape models, the baseline `GarmentFullPattern3D` and the attention
model `GarmentSegmentPattern3D`, with each variant of the port's slice of
alternative encoders and decoders, against the JAX package's eval forward
on the same weights (`state_dict_from_flax`):

  pool10     EdgeConvPoolingFeatures at k_neighbors 10, a GRU panel decoder
             and a double-reverse LSTM pattern decoder;
  gpool      EdgeConvFeatures with graph pooling (no xyz skip);
  aggr_mean, aggr_add   the mean and add EdgeConv aggregations;
  pointnet   PointNetPlusPlus with MLP decoders.

The attention model takes the variant's panel decoder. Widths are cut
(EConv 16/24, hidden 32, 2 LSTM layers, 6 panels x 5 edges, 128 points,
pool_ratio 0.25 so the pooled clouds keep 8 points); BN statistics are
perturbed. The JAX side runs as in tests/test_torch_encoders.py (Pallas in
interpret mode, the pool's kNN included), with its tolerances: 1e-2 of each
output's largest magnitude at most, 1e-4 on average.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import DATA_CONFIG, LOSS_CONFIG
from garment_pattern_estimation_tpu.models import build_model as jax_build_model
from garment_pattern_estimation_torch.models import build_model, state_dict_from_flax
from test_torch_encoders import assert_close, jax_forward, pallas_pool_knn, perturbed  # noqa: F401

torch.set_num_threads(1)


_DATA = dict(DATA_CONFIG, max_panel_len=5, max_pattern_len=6)
_NN = {'panel_encoding_size': 32, 'panel_hidden_size': 32, 'panel_n_layers': 2,
       'pattern_encoding_size': 32, 'pattern_hidden_size': 32, 'pattern_n_layers': 2,
       'EConv_hidden': 16, 'EConv_feature': 24, 'EConv_hidden_depth': 2,
       'k_neighbors': 5, 'conv_depth': 2, 'skip_connections': True,
       'global_pool': 'mean', 'local_attention': True}
VARIANTS = {
    'pool10': {'feature_extractor': 'EdgeConvPoolingFeatures', 'k_neighbors': 10,
               'pool_ratio': 0.25, 'panel_decoder': 'GRUDecoderModule',
               'pattern_decoder': 'LSTMDoubleReverseDecoderModule'},
    'gpool': {'graph_pooling': True, 'skip_connections': False, 'pool_ratio': 0.25},
    'aggr_mean': {'EConv_aggr': 'mean'},
    'aggr_add': {'EConv_aggr': 'add'},
    'pointnet': {'feature_extractor': 'PointNetPlusPlus', 'panel_decoder': 'MLPDecoder',
                 'pattern_decoder': 'MLPDecoder'},
}


@pytest.mark.parametrize('model_name', ['GarmentFullPattern3D', 'GarmentSegmentPattern3D'])
@pytest.mark.parametrize('variant', list(VARIANTS))
def test_model_variant_matches_jax(pallas_pool_knn, model_name, variant):
    """The eval forward of each model with each variant's NN keys (the
    attention model takes the variant's panel decoder), its outputs and
    the attention weights over the encoder's own point count."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 128, 3)).astype(np.float32)
    nn_config = dict(_NN, **VARIANTS[variant])
    if model_name == 'GarmentSegmentPattern3D':
        nn_config.pop('pattern_decoder', None)
    plain = jax_build_model(model_name, _DATA, nn_config, LOSS_CONFIG, use_pallas=False)
    module = jax_build_model(model_name, _DATA, nn_config, LOSS_CONFIG, use_pallas=True).module
    variables = perturbed(jax.jit(plain.init_variables)(jax.random.PRNGKey(0), jnp.asarray(x)),
                          rng)
    ref, _ = jax_forward(module, variables, jnp.asarray(x))
    model = build_model(model_name, _DATA, nn_config, device='cpu')
    assert model.config['pool_ratio'] == nn_config.get('pool_ratio', 0.1)
    model.module.load_state_dict(state_dict_from_flax(variables))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    assert sorted(out) == sorted(ref)
    for key in ref:
        assert_close(out[key].numpy(), ref[key])
