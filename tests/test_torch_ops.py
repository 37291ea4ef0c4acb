"""The port's plain ops of the serving path against the JAX package's:
sparsemax (the sort-free form for up to 64 classes, the sorted form above)
and the masked pools. Same numpy inputs to both. Both frameworks compute
these in f32 with sums in possibly another order, so values are held to
1e-5 relative / 1e-6 absolute; the sparsemax supports (exact zeros) must
match exactly."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from garment_pattern_estimation_tpu.ops import pooling as jax_pooling
from garment_pattern_estimation_tpu.ops.sparsemax import sparsemax as jax_sparsemax
from garment_pattern_estimation_torch.ops import pooling
from garment_pattern_estimation_torch.ops.sparsemax import sparsemax

torch.set_num_threads(1)


@pytest.mark.parametrize('n_classes', [23, 100])
def test_sparsemax_matches_jax(rng, n_classes):
    z = (rng.normal(size=(4, 50, n_classes)) * 3).astype(np.float32)
    z[0, 0, :3] = z[0, 0, 3]                 # a tie group
    ours = sparsemax(torch.from_numpy(z)).numpy()
    theirs = np.asarray(jax_sparsemax(jnp.asarray(z)))
    np.testing.assert_array_equal(ours > 0, theirs > 0)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize('pool', ['max', 'mean', 'add'])
@pytest.mark.parametrize('masked', [False, True])
def test_pools_match_jax(rng, pool, masked):
    x = rng.normal(size=(3, 40, 7)).astype(np.float32)
    mask = rng.random(size=(3, 40)) > 0.3 if masked else None
    ours = pooling.GLOBAL_POOLS[pool](
        torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    theirs = jax_pooling.GLOBAL_POOLS[pool](
        jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-6)
