"""The port's serving pipeline against the JAX package's `build_serving_fn`:
standardize the raw cloud, eval forward, un-standardize. Same weights, same
raw points (in physical units, built from the published standardization
statistics). Tolerances as in test_torch_model.py: 1e-2 of each output's
largest magnitude at most, 1e-4 on average (bf16 truncation flips)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from garment_pattern_estimation_tpu.experiment.serving import (
    build_serving_fn as jax_build_serving_fn)
from garment_pattern_estimation_torch.experiment import build_serving_fn
from garment_pattern_estimation_torch.models import build_model
from test_torch_model import DATA, KEYS, NN, assert_close_to_scale, shared_model

torch.set_num_threads(1)

SERVE_DATA = dict(DATA, standardize=dict(
    DATA['standardize'],
    f_scale=[16.351303100585938, 30.945703506469727, 9.60141944885254],
    f_shift=[0.037076108157634735, -28.06070327758789, 1.0775548219680786]))


@pytest.fixture(scope='module')
def served():
    jax_model, variables, model, x = shared_model(seed=1, n_points=96)
    std = SERVE_DATA['standardize']
    points = x * np.float32(std['f_scale']) + np.float32(std['f_shift'])
    ref = jax_build_serving_fn(jax_model, variables, SERVE_DATA)(jnp.asarray(points))
    out = build_serving_fn(model, SERVE_DATA)(torch.from_numpy(points))
    return {k: np.asarray(v) for k, v in ref.items()}, {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize('key', KEYS)
def test_serving_matches_jax(served, key):
    ref, out = served
    assert_close_to_scale(out[key], ref[key])


def test_serving_unstandardizes():
    """Identity statistics leave the forward untouched; a shift moves it."""
    model = build_model('GarmentSegmentPattern3D', DATA, NN, device='cpu', seed=2)
    x = np.random.default_rng(2).normal(size=(2, 32, 3)).astype(np.float32)
    plain = build_serving_fn(model, {})(x)
    with torch.no_grad():
        direct = model(torch.from_numpy(x))
    for key in KEYS:
        torch.testing.assert_close(plain[key], direct[key])
    shifted = build_serving_fn(model, {'standardize': {
        'gt_shift': {'translations': [1.0, 2.0, 3.0]},
        'gt_scale': {'translations': [1.0, 1.0, 1.0]}}})(x)
    torch.testing.assert_close(shifted['translations'],
                               direct['translations'] + torch.tensor([1.0, 2.0, 3.0]))
