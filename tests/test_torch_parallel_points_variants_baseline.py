"""Points-sharded training (`trainer.mesh: {data: d, points: 2}`) on gloo
CPU ranks of the baseline with PointNet++ and MLP decoders
(`pointnet_baseline`): its global encoding is PointNet++'s max pool over
every rank's centroids (the all-reduce max), which the attention model's
cases leave unused. Against the port's one-process step on the padded
batch at {1, 2} and {2, 2}, in f32 and in float64, and against the JAX
package's 2-D mesh at {1, 2}; the run and its bars:
tests/torch_points_variants.py.
"""
import pytest
import torch

import torch_points_variants as variants

torch.set_num_threads(1)

CASES = ('pointnet_baseline',)


@pytest.fixture(scope='module', params=[1, 2], ids=['1x2', '2x2'])
def variants_run(request, tmp_path_factory):
    return variants.run(CASES, request.param,
                        tmp_path_factory.mktemp(f'variants{request.param}'))


@pytest.mark.parametrize('case', CASES)
def test_points_sharded_variant_equals_one_process(variants_run, case):
    variants.check_one_process(variants_run, case)


@pytest.mark.parametrize('case', CASES)
def test_points_sharded_variant_equals_one_process_in_float64(variants_run, case):
    variants.check_float64(variants_run, case)


@pytest.mark.parametrize('variants_run', [1], indirect=True, ids=['1x2'])
@pytest.mark.parametrize('case', CASES)
def test_points_sharded_variant_matches_jax_mesh(variants_run, case):
    variants.check_jax_mesh(variants_run, case)
