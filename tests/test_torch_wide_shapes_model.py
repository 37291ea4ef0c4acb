"""The attention model at the widths the card used to refuse: `NN.EConv_feature`
300 (conv1 takes 300 channels), `NN.EConv_hidden` 512 and
`NN.EConv_hidden_depth` 4 (five edge-MLP layers), against the JAX package
on the same weights carried across by `state_dict_from_flax`; the JAX side
through its Pallas kernels in interpret mode (use_pallas=True), the port's
through its plain versions on the CPU. At EConv_feature 300 both models
route conv1 to knn_gather in eval too (C > 256 is past both packages'
`fused_edgeconv_supported`).

Tolerances, those of tests/test_torch_model.py and
tests/test_torch_k_range_step.py: every eval output within 1e-2 of its
largest magnitude, 1e-4 on average; one train step's loss within 1e-4
relative and each parameter's gradient within 1e-3 of its largest
magnitude. Clouds of 48-64 points, cut for the interpret-mode kernels' time.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from garment_pattern_estimation_tpu.models import build_model as jax_build_model
from garment_pattern_estimation_torch.models import build_model, state_dict_from_flax
from garment_pattern_estimation_torch.train import Trainer
from test_torch_model import KEYS, NN as MODEL_NN, assert_close_to_scale, shared_model
from test_torch_train import DATA, LOSS, NN as TRAIN_NN, SETUP, _ground_truth, _torch

torch.set_num_threads(1)

WIDE = {'feature_300': {'EConv_feature': 300}, 'hidden_512': {'EConv_hidden': 512},
        'depth_4': {'EConv_hidden_depth': 4}}


@pytest.mark.parametrize('change', list(WIDE))
def test_att_model_forward_matches_jax_at_wide_shapes(change):
    jax_model, variables, model, x = shared_model(seed=7, n_points=64,
                                                  nn_config=dict(MODEL_NN, **WIDE[change]))
    ref = jax_model.module.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for key in KEYS:
        assert_close_to_scale(out[key].numpy(), np.asarray(ref[key]))


@pytest.mark.parametrize('change', list(WIDE))
def test_att_train_step_matches_jax_at_wide_shapes(change):
    nn_config = dict(TRAIN_NN, **WIDE[change])
    rng = np.random.default_rng(17)
    batch = {'features': rng.normal(size=(2, 48, 3)).astype(np.float32),
             'ground_truth': _ground_truth(rng, N=48)}
    jax_model = jax_build_model('GarmentSegmentPattern3D', DATA, nn_config, LOSS,
                                use_pallas=True)
    variables = jax.tree_util.tree_map(np.asarray, jax_model.init_variables(
        jax.random.PRNGKey(0), jnp.asarray(batch['features'])))

    def loss_fn(p):
        preds, mutated = jax_model.module.apply(
            {'params': p, 'batch_stats': variables['batch_stats']},
            jnp.asarray(batch['features']), train=True, mutable=['batch_stats'])
        loss, _, _ = jax_model.loss(preds, jax.tree_util.tree_map(jnp.asarray,
                                                                   batch['ground_truth']),
                                    epoch=0)
        return loss, mutated['batch_stats']

    (jax_loss, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(variables['params'])
    jax_grads = state_dict_from_flax({'params': jax.tree_util.tree_map(np.asarray, grads),
                                      'batch_stats': jax.tree_util.tree_map(np.asarray, stats)})

    model = build_model('GarmentSegmentPattern3D', DATA, nn_config, LOSS, device='cpu')
    model.module.load_state_dict(state_dict_from_flax(variables))
    trainer = Trainer(SETUP, device='cpu')
    trainer.make_optimizer(model, 1)
    loss, _ = trainer.train_step(model, {'features': torch.from_numpy(batch['features']),
                                         'ground_truth': _torch(batch['ground_truth'])}, 0)
    np.testing.assert_allclose(float(loss), float(jax_loss), rtol=1e-4)
    for name, param in model.module.named_parameters():
        ref = jax_grads[name].numpy()
        scale = float(np.abs(ref).max())
        assert scale > 0, name
        assert np.abs(param.grad.numpy() - ref).max() <= 1e-3 * scale, name
