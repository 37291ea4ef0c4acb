"""Points-sharded training (`trainer.mesh: {data: d, points: 2}`) on gloo
CPU ranks with the encoders that leave the ring: `EdgeConvPoolingFeatures`
(`pool10`: conv1 on the ring, then pool1 gathers its input and the rest
runs on whole clouds) and `PointNetPlusPlus` (the positions gathered, FPS
on the whole clouds, each rank's share of the centroids; `pointnet_uneven`:
76 points give 15 centroids, 8 and 7 a rank, so the BatchNorm moments and
the attention pool's mean weigh by rows). Each case against the port's
one-process step on the padded batch at {1, 2} and {2, 2}, and against the
JAX package's 2-D mesh at {1, 2}; the run and its bars:
tests/torch_points_variants.py.
"""
import pytest
import torch

import torch_points_variants as variants

torch.set_num_threads(1)

CASES = ('pool10', 'pointnet', 'pointnet_uneven')


@pytest.fixture(scope='module', params=[1, 2], ids=['1x2', '2x2'])
def variants_run(request, tmp_path_factory):
    return variants.run(CASES, request.param,
                        tmp_path_factory.mktemp(f'variants{request.param}'))


@pytest.mark.parametrize('case', CASES)
def test_points_sharded_variant_equals_one_process(variants_run, case):
    variants.check_one_process(variants_run, case)


@pytest.mark.parametrize('variants_run', [1], indirect=True, ids=['1x2'])
@pytest.mark.parametrize('case', CASES)
def test_points_sharded_variant_matches_jax_mesh(variants_run, case):
    variants.check_jax_mesh(variants_run, case)
