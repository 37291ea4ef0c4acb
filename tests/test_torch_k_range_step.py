"""One training step of the attention model at k_neighbors 20 (DGCNN's
published k) against the JAX package: tests/test_torch_train.py's narrow
att model, loss and Adam setup, the same weights carried across by
`state_dict_from_flax`, the JAX train-mode EdgeConv through its
interpret-mode knn_gather kernels (use_pallas=True), the port's through its
plain versions on the CPU.

Tolerances, tests/test_torch_train.py's at step 0: the loss within 1e-4
relative, each parameter's gradient within 1e-3 of its largest magnitude.
The clouds have STEP_POINTS points, cut for the interpret-mode kernels'
time. At tests/test_torch_train.py's 128 points (seed 13) the gradient of
conv0's first layer differed by 1.4e-3 of its scale, but there 1e-7
relative noise on the cloud alone moves the port's own gradient by up to
6.8e-3 of a parameter's scale (a near tie of the wide-C selection or a
ReLU boundary flips), so that size probes the noise, not the parity; at
STEP_POINTS the gap is 2.7e-5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import torch

from garment_pattern_estimation_tpu.models import build_model as jax_build_model
from garment_pattern_estimation_torch.models import build_model, state_dict_from_flax
from garment_pattern_estimation_torch.train import Trainer
from test_torch_train import DATA, LOSS, NN as TRAIN_NN, SETUP, _ground_truth, _torch

torch.set_num_threads(1)

STEP_POINTS = 48


def test_att_train_step_matches_jax_at_k20():
    """One Adam step of the narrow att model of tests/test_torch_train.py at
    k_neighbors 20 from the same weights, on STEP_POINTS points: the loss
    and every parameter's gradient (the JAX train-mode EdgeConv through the
    interpret-mode knn_gather kernels, the port's through its plain
    versions)."""
    nn_config = dict(TRAIN_NN, k_neighbors=20)
    rng = np.random.default_rng(13)
    batch = {'features': rng.normal(size=(2, STEP_POINTS, 3)).astype(np.float32),
             'ground_truth': _ground_truth(rng, N=STEP_POINTS)}
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
