"""The port's fused EdgeConv past the single-tile bound against the JAX
package's column-tiled kernels (`_fused_kernel_direct_tiled` for small C,
`_fused_kernel_stream` for wide C), run in interpret mode: forced onto
64-column tiles at N = 200, and at their own tiles at N = 2100 > 2048; then
the whole served model at N = 2100, whose JAX eval runs both tiled kernels.
The port runs its plain layer, whose selection ranks (quantized distance,
column) for any N.

Tolerances as in test_torch_edgeconv.py: outputs within 1e-2 of their
largest magnitude at most and 1e-4 on average (a 1-ulp sum-order difference
can flip one bf16 truncation in the edge MLP); the served model's keys
likewise, as in test_torch_serving.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from garment_pattern_estimation_tpu.experiment.serving import (
    build_serving_fn as jax_build_serving_fn)
from garment_pattern_estimation_tpu.ops import edgeconv as jax_edgeconv
from garment_pattern_estimation_torch.experiment import build_serving_fn
from garment_pattern_estimation_torch.ops import edgeconv
from test_torch_edgeconv import (_assert_close_to_scale, _jax_fold, _synthetic_mlp,
                                 _torch_fold)
from test_torch_model import KEYS, assert_close_to_scale, shared_model
from test_torch_serving import SERVE_DATA

torch.set_num_threads(1)


def _compare(rng, n_points, C, mlp_dtype, batch, **jax_kwargs):
    layers = _synthetic_mlp(rng, [(2 * C, 16), (16, 16), (16, 24)])
    x = rng.normal(size=(batch, n_points, C)).astype(np.float32)
    kernel = jax_edgeconv.fused_edgeconv(jnp.asarray(x), _jax_fold(layers), k=5,
                                         mlp_dtype=getattr(jnp, mlp_dtype),
                                         interpret=True, **jax_kwargs)
    before = dict(edgeconv.launches)
    out = edgeconv.fused_edgeconv(torch.from_numpy(x), _torch_fold(layers), k=5,
                                  mlp_dtype=getattr(torch, mlp_dtype))
    assert edgeconv.launches == before        # the CPU takes the plain version
    _assert_close_to_scale(out.numpy(), np.asarray(kernel))


@pytest.mark.parametrize('C,mlp_dtype', [
    (6, 'float32'), (6, 'bfloat16'), (24, 'float32'), (24, 'bfloat16')])
def test_plain_matches_jax_forced_tiles(rng, C, mlp_dtype):
    _compare(rng, 200, C, mlp_dtype, batch=2, tile_n=64)


@pytest.mark.parametrize('C', [3, 24])
def test_plain_matches_jax_past_the_single_tile_bound(rng, C):
    _compare(rng, 2100, C, 'float32', batch=1)


def test_served_model_matches_jax_past_the_single_tile_bound():
    """Small widths (EConv 16/24, so conv1 is wide C), a (2, 2100, 3) cloud
    in physical units: every output key of the port's serving pipeline
    against the JAX package's, whose EdgeConv layers run the column-tiled
    kernels."""
    jax_model, variables, model, _ = shared_model(seed=1, n_points=64)
    std = SERVE_DATA['standardize']
    x = np.random.default_rng(5).normal(size=(2, 2100, 3)).astype(np.float32)
    points = x * np.float32(std['f_scale']) + np.float32(std['f_shift'])
    ref = jax_build_serving_fn(jax_model, variables, SERVE_DATA)(jnp.asarray(points))
    out = build_serving_fn(model, SERVE_DATA)(torch.from_numpy(points))
    assert sorted(out) == sorted(KEYS)
    assert out['att_weights'].shape == (2, 2100, SERVE_DATA['max_pattern_len'])
    for key in KEYS:
        assert_close_to_scale(out[key].numpy(), np.asarray(ref[key]))


@pytest.mark.parametrize('device', ['cpu', 'meta'])
def test_past_the_fused_bound_raises(rng, device):
    layers = _synthetic_mlp(rng, [(6, 8), (8, 8)])
    x = torch.zeros(1, edgeconv.MAX_FUSED_N + 1, 3, device=device)
    with pytest.raises(NotImplementedError, match='unfused kNN path'):
        edgeconv.fused_edgeconv(x, _torch_fold(layers), k=5)


class _CudaStandIn:
    """Shape and device of a CUDA tensor, for routing checks without a card."""

    def __init__(self, *shape):
        self.shape = shape
        self.device = torch.device('cuda')


@pytest.mark.parametrize('n_points', [2000, 10000, edgeconv.MAX_FUSED_N])
def test_cuda_tensor_never_takes_the_plain_version(rng, monkeypatch, n_points):
    def plain(*args, **kwargs):
        raise AssertionError('a CUDA tensor reached the plain version')

    launched = []
    monkeypatch.setattr(edgeconv, 'fused_edgeconv_reference', plain)
    monkeypatch.setattr(edgeconv, 'edgeconv_select', plain)
    monkeypatch.setattr(edgeconv, '_launch', lambda *args: launched.append(args))
    layers = _synthetic_mlp(rng, [(6, 8), (8, 8)])
    edgeconv.fused_edgeconv(_CudaStandIn(2, n_points, 3), _torch_fold(layers), k=5)
    assert len(launched) == 1
