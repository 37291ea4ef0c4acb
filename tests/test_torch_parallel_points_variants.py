"""Points-sharded training (`trainer.mesh: {data: d, points: p}`) on gloo
CPU ranks with what a points shard of the attention model reduces over
every points rank: a `max` global pool and attention pool (the all-reduce
max), the `segmentation` term (this rank's points of the labels, the mean
over every rank's), and graph pooling (`gpool`: conv0 on the ring, then the
first pool gathers its input and the rest runs on whole clouds). Each case
against the port's one-process step on the padded batch at {1, 2}, {2, 2}
and {1, 4}, and against the JAX package's 2-D mesh at {1, 2}; the run and its
bars: tests/torch_points_variants.py. The encoders' cases are in
tests/test_torch_parallel_points_variants_encoders.py.
"""
import pytest
import torch

import torch_points_variants as variants

torch.set_num_threads(1)

CASES = ('max_pools', 'segmentation', 'gpool')


@pytest.fixture(scope='module', params=[(1, 2), (2, 2), (1, 4)], ids=['1x2', '2x2', '1x4'])
def variants_run(request, tmp_path_factory):
    data, points = request.param
    return variants.run(CASES, data, tmp_path_factory.mktemp(f'variants{data}x{points}'),
                        points)


@pytest.mark.parametrize('case', CASES)
def test_points_sharded_variant_equals_one_process(variants_run, case):
    variants.check_one_process(variants_run, case)


@pytest.mark.parametrize('variants_run', [(1, 2)], indirect=True, ids=['1x2'])
@pytest.mark.parametrize('case', CASES)
def test_points_sharded_variant_matches_jax_mesh(variants_run, case):
    variants.check_jax_mesh(variants_run, case)
