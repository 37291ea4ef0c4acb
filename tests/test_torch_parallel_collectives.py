"""The points collectives of points-sharded training on 2 and 4 gloo CPU
ranks (tests/torch_parallel_ranks.py's `collectives_rank`, no JAX) against
one process's autograd, each used as the trainer uses it: only points rank
0 backpropagates, the others backpropagate zeros.

  * `PointsShard.max` (`collectives.all_reduce_max`): the value, and the
    gradient split evenly over tied maxima counted over every rank: two
    ties in one rank's points, two across rank 0's and rank 1's, and a
    channel equal everywhere, as `torch.amax` (and `jnp.max`) split it;
  * `PointsShard.gather` over uneven shares (`PointsShard.sizes`): the
    whole tensor in global order, and every rank's slice of rank 0's
    cotangent as its gradient (a gather whose backward kept each rank's
    own cotangent would hand the other ranks zeros);
  * an `MLP`'s train forward with its rows split unevenly over the points
    ranks: the outputs, the running statistics and the parameters'
    gradients summed over the mesh, against the MLP on all the rows (its
    BatchNorm moments weighed by each rank's rows, the counts summed
    over the mesh;
    unweighted means of the ranks' moments are off by a share of the
    difference).

  * `DataShard.mean` of one value a rank over equal counts: the f32
    rounding of the ranks' mean taken in f64, bitwise (an f32 sum of the
    shares rounds once more, and through a BatchNorm variance that
    cancels that moved the graph-pooled model's gradient at {data: 1,
    points: 4} beyond its bar: fault C11).

Values within 1e-6 of their scale, gradients within 1e-5 (f32 sums in
another order); the gathered values and the max's exactly.
"""
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from garment_pattern_estimation_torch.models.blocks import MLP
from garment_pattern_estimation_torch.parallel.dryrun import spawn

torch.set_num_threads(1)


def close(ours, ref, rel):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * max(float(np.abs(ref).max()), 1.0))


@pytest.fixture(scope='module', params=[2, 4], ids=['2ranks', '4ranks'])
def collectives_run(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f'collectives{request.param}')
    inputs = ranks.collective_inputs(request.param)
    np.savez(tmp / 'inputs.npz', **inputs)
    spawn(ranks.collectives_rank, request.param, str(tmp / 'inputs.npz'), str(tmp / 'out.npz'))
    return inputs, dict(np.load(tmp / 'out.npz'))


def test_all_reduce_max_splits_ties_over_every_rank(collectives_run):
    inputs, out = collectives_run
    x = torch.from_numpy(inputs['max.x']).requires_grad_()
    top = torch.amax(x, dim=1)
    torch.sum(top * torch.from_numpy(inputs['max.w'])).backward()
    assert np.array_equal(out['max.value'], top.detach().numpy())
    close(out['max.grad'], x.grad, 1e-6)
    w = inputs['max.w']
    assert np.isclose(out['max.grad'][0, 1, 0], w[0, 0] / 2)      # two ties in rank 0
    assert np.isclose(out['max.grad'][0, 4 + 3, 1], w[0, 1] / 2)  # rank 0 and rank 1
    assert np.allclose(out['max.grad'][1, :, 2], w[1, 2] / x.shape[1])


def test_points_gather_backward_hands_each_rank_its_slice(collectives_run):
    inputs, out = collectives_run
    assert np.array_equal(out['gather.value'], inputs['gather.x'])
    assert np.array_equal(out['gather.grad'], inputs['gather.w'])


def test_data_shard_mean_rounds_once(collectives_run):
    inputs, out = collectives_run
    v = inputs['mean.v'].astype(np.float64)
    assert np.array_equal(out['mean.value'], (v / len(v)).sum(axis=0).astype(np.float32))


def test_uneven_rows_batchnorm_moments(collectives_run):
    inputs, out = collectives_run
    mlp = MLP([6, 8, 4])
    mlp.load_state_dict({k[len('mlp.state.'):]: torch.from_numpy(v) for k, v in inputs.items()
                         if k.startswith('mlp.state.')})
    y = mlp(torch.from_numpy(inputs['mlp.rows']))
    torch.sum(y * torch.from_numpy(inputs['mlp.w'])).backward()
    close(out['mlp.y'], y.detach(), 1e-6)
    for n, b in mlp.named_buffers():
        if 'running' in n:
            close(out[f'mlp.buffer.{n}'], b, 1e-6)
    for n, p in mlp.named_parameters():
        close(out[f'mlp.grad.{n}'], p.grad, 1e-5)
