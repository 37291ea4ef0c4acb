"""The EdgeConv module and the attention model at k_neighbors 20 (DGCNN's
published k) against the JAX package, on the same weights carried across
by `state_dict_from_flax`: the port's plain versions on the CPU, the JAX
side through its Pallas kernels in interpret mode (use_pallas=True).

Tolerances, those of the k = 5 files:
  * EdgeConv in train mode: output and running statistics 1e-5 of their
    scale, gradients 1e-4 (tests/test_torch_knn_gather.py);
  * the att model (tests/test_torch_model.py's widths): every output within
    1e-2 of its largest magnitude, 1e-4 on average.
One train step of the att model is in tests/test_torch_k_range_step.py.
Sizes are cut for the interpret-mode kernels' time: 64-80 points a cloud.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from garment_pattern_estimation_tpu.models.blocks import EdgeConv as JaxEdgeConv
from garment_pattern_estimation_torch.models.blocks import EdgeConv
from garment_pattern_estimation_torch.models.flax_import import _mlp
from test_torch_model import KEYS, NN as MODEL_NN, assert_close_to_scale, shared_model

torch.set_num_threads(1)


def _close_rel(ours, theirs, rel):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    assert np.abs(ours - theirs).max() <= rel * np.abs(theirs).max()


@pytest.mark.parametrize('c', [3, 24])
def test_edgeconv_train_mode_matches_jax_at_k20(rng, c):
    x = rng.normal(size=(2, 80, c)).astype(np.float32)
    jax_layer = JaxEdgeConv([24, 24, 16], k=20, use_pallas=True)
    variables = jax.tree_util.tree_map(np.asarray, jax_layer.init(
        {'params': jax.random.PRNGKey(1)}, jnp.asarray(x), train=True))

    def jax_loss(params, xx):
        out, mutated = jax_layer.apply(
            {'params': params, 'batch_stats': variables['batch_stats']}, xx,
            train=True, mutable=['batch_stats'])
        return jnp.sum(jnp.tanh(out) ** 2), (out, mutated['batch_stats'])

    (_, (ref_out, ref_stats)), (ref_gp, ref_gx) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(variables['params'], jnp.asarray(x))

    layer = EdgeConv(c, [24, 24, 16], k=20).train()
    state = {}
    _mlp(state, 'nn', variables['params']['MLP_0'], variables['batch_stats']['MLP_0'])
    layer.load_state_dict(state)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = layer(xt)
    torch.sum(torch.tanh(out) ** 2).backward()

    _close_rel(out.detach().numpy(), ref_out, 1e-5)
    new_stats, grads = {}, {}
    _mlp(new_stats, 'nn', variables['params']['MLP_0'], ref_stats['MLP_0'])
    _mlp(grads, 'nn', ref_gp['MLP_0'], ref_stats['MLP_0'])
    for name, value in layer.state_dict().items():
        if 'running' in name:
            _close_rel(value.numpy(), new_stats[name].numpy(), 1e-5)
    for name, param in layer.named_parameters():
        _close_rel(param.grad.numpy(), grads[name].numpy(), 1e-4)
    _close_rel(xt.grad.numpy(), ref_gx, 1e-4)


def test_att_model_forward_matches_jax_at_k20():
    """The narrow att model of tests/test_torch_model.py at k_neighbors 20:
    the JAX forward through the interpret-mode fused kernel, the port's
    through its plain fused layer."""
    jax_model, variables, model, x = shared_model(seed=5, n_points=64,
                                                  nn_config=dict(MODEL_NN, k_neighbors=20))
    ref = jax_model.module.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for key in KEYS:
        assert_close_to_scale(out[key].numpy(), np.asarray(ref[key]))
