"""Points-sharded training (`trainer.mesh: {data: d, points: p}`) on gloo CPU
ranks against the port's one-process step and the JAX package's step over
its 2-D mesh, the 2-D part of the dry run, and the ring's ranking on point
shards against the selection of the whole cloud.

The ranks run tests/torch_parallel_ranks.py's `points_rank` (no JAX) on
tests/test_multichip.py's remainder batch (B = 5 clouds of 32 points) at
{data: 1, points: 2} (2 ranks), {data: 2, points: 2} (4 ranks, the batch
padded to 6) and {data: 1, points: 4} (4 ranks, 8 points each). A cloud
that does not split over the points ranks (30 points over 4) is refused by
both packages: the JAX mesh's `device_put` and the port's `PointsShard`,
on every rank before any collective. The reference is the port's one-process step on the batch
padded to d, its predictions cut to the 5 real clouds before the loss.
Three cases: zero LSTM states, drawn states with dropout (draws of the
global batch), and a second EdgeConv layer at C = 24 (past the exact
per-dimension ranking: the split products and knn_gather's split rows).
The zero-state and C = 24 cases start from the JAX model's weights
(`use_pallas=False`, as the JAX trainer runs a points mesh), so their
steps are also held against `JaxTrainer` over `make_mesh_2d(d, 2)`.

Bars, those of the JAX package's points-sharded test
(tests/test_multichip.py:204) and of the DP tests:
  * the losses of 2 steps within rtol 2e-5 (the one process ranks the same
    neighbours: the ring takes the fused layer's and knn_gather's ranking,
    and f32 sums of the ranks' shares run in another order);
  * the first step's gradient within 1e-5 of its norm, or twice the order
    floor where that is larger: the gap one process's gradient takes when
    the clouds are scaled by 1 + 1e-7 noise (the C = 24 case from the JAX
    weights: floor 1.50e-5 and gap 1.45e-5 at {data: 1, points: 2}, floor
    7.5e-6 at {data: 2, points: 2}; the other cases' floors are below
    1e-6). A gradient counted p times (the
    post-pool layers summed over the points ranks), or a points rank's
    share dropped, is off by a good part of its norm;
  * the eval loss after the steps within rtol 2e-5 of the JAX 2-D mesh's
    (both run the unfused layer in f32 on a points shard; the one-process
    eval runs the fused layer's bf16 edge MLP instead).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from garment_pattern_estimation_tpu.models import build_model as jax_build_model
from garment_pattern_estimation_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from garment_pattern_estimation_tpu.train.trainer import Trainer as JaxTrainer
from garment_pattern_estimation_torch.models import state_dict_from_flax
from garment_pattern_estimation_torch.ops.edgeconv import (edgeconv_select, edgeconv_sq_dists,
                                                           gathered_rows)
from garment_pattern_estimation_torch.ops.knn import truncate_bf16
from garment_pattern_estimation_torch.parallel.dryrun import dryrun_multichip, spawn
from garment_pattern_estimation_torch.parallel.ring import (_ring_init, _ring_merge,
                                                            _ring_output, low_precision_rows)

torch.set_num_threads(1)

JAX_CASES = ('zero_states', 'wide')       # weights from the JAX model, zero LSTM states


def _jax_model(case):
    """The case's JAX model (`use_pallas=False`) and its seed-0 variables."""
    model = jax_build_model('GarmentSegmentPattern3D', ranks.DATA, ranks.MODELS[case][0],
                            ranks.LOSS, use_pallas=False)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init_variables)(
        jax.random.PRNGKey(0), jnp.zeros((2, ranks.N, 3), jnp.float32)))
    return model, variables


def _jax_steps(model, variables, arrays, data, points):
    """JaxTrainer's two train steps and then an eval step over
    `make_mesh_2d(data, points)`: (the two losses, the eval loss)."""
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.mesh, jt._step_cache, jt._monitor_needs_quality = jax_make_mesh_2d(data, points), {}, \
        False
    jt.setup = dict(ranks.SETUP)
    tx = jt._make_optimizer(ranks.STEPS_PER_EPOCH)
    gt = {k[3:]: v for k, v in arrays.items() if k.startswith('gt.')}
    placed, real = jt._place_batch({'features': arrays['features'], 'ground_truth': gt})
    assert placed['features'].sharding.spec[1] == 'points'
    params = jax.tree_util.tree_map(jnp.array, variables['params'])
    stats = jax.tree_util.tree_map(jnp.array, variables['batch_stats'])
    opt_state = tx.init(params)
    step = jt._train_step_fn(model, tx, (False, False), real)
    losses = []
    for i in range(2):
        params, stats, opt_state, loss, _ = step(params, stats, opt_state, placed,
                                                 jax.random.PRNGKey(i))
        losses.append(float(loss))
    eval_loss, _ = jt._eval_step_fn(model, (False, False), real)(
        params, stats, placed, jax.random.PRNGKey(7))
    return losses, float(eval_loss)


@pytest.fixture(scope='module', params=[(1, 2), (2, 2), (1, 4)], ids=['1x2', '2x2', '1x4'])
def points_run(request, tmp_path_factory):
    """(the ranks' results, the one-process references, the JAX 2-D mesh's
    (losses, eval loss) by case) at {data: d, points: p}."""
    data, points = request.param
    tmp = tmp_path_factory.mktemp(f'points{data}x{points}')
    jax_models = {case: _jax_model(case) for case in JAX_CASES}
    states = {case: {k: v.numpy() for k, v in state_dict_from_flax(variables).items()}
              for case, (_, variables) in jax_models.items()}
    states['drawn'] = ranks.port_state('drawn')
    arrays = ranks.write_inputs(tmp / 'inputs.npz', states)
    with np.load(tmp / 'inputs.npz') as loaded:
        np.savez(tmp / 'inputs.npz', **dict(loaded), **{'mesh.data': np.asarray(data)})
    spawn(ranks.points_rank, data * points, str(tmp / 'inputs.npz'), str(tmp / 'out.npz'))
    batch = ranks.batch_of(arrays)
    oracles = {case: ranks.padded_oracle(case, states[case], batch, data)
               for case in ranks.POINTS_CASES}
    jax_runs = {case: _jax_steps(model, variables, arrays, data, points)
                for case, (model, variables) in jax_models.items()}
    noise = torch.randn(batch['features'].shape, generator=torch.Generator().manual_seed(5))
    perturbed = dict(batch, features=batch['features'] * (1 + 1e-7 * noise))
    floors = {}
    for case in ranks.POINTS_CASES:
        grads = oracles[case][1]
        moved = ranks.padded_oracle(case, states[case], perturbed, data)[1]
        floors[case] = ranks.gradient_gap(
            {f'{case}.grad.{n}': g.numpy() for n, g in moved.items()}, case, grads)[0]
    return dict(np.load(tmp / 'out.npz')), oracles, jax_runs, floors


@pytest.mark.parametrize('case', ranks.POINTS_CASES)
def test_points_sharded_steps_equal_one_process(points_run, case):
    out, oracles, _, floors = points_run
    losses, grads, _ = oracles[case]
    np.testing.assert_allclose([out[f'{case}.loss0'], out[f'{case}.loss1']], losses, rtol=2e-5)
    gap, same_names = ranks.gradient_gap(out, case, grads)
    assert same_names and gap <= max(1e-5, 2 * floors[case]), (case, gap, floors[case])
    assert bool(out[f'{case}.same_params'])
    assert np.isfinite(out[f'{case}.eval'])


@pytest.mark.parametrize('case', JAX_CASES)
def test_points_sharded_steps_match_jax_mesh(points_run, case):
    """The two step losses and the eval loss after them against the JAX
    trainer's over its 2-D mesh, from the same weights."""
    out, _, jax_runs, _ = points_run
    losses, eval_loss = jax_runs[case]
    np.testing.assert_allclose([out[f'{case}.loss0'], out[f'{case}.loss1']], losses, rtol=2e-5)
    np.testing.assert_allclose(out[f'{case}.eval'], eval_loss, rtol=2e-5)


def test_points_mesh_refuses_a_cloud_that_does_not_split(tmp_path):
    """30 points over {data: 1, points: 4}: the port's train step raises
    ValueError on every rank before any collective (`PointsShard.local`),
    as the JAX trainer's placement over `make_mesh_2d(1, 4)` raises."""
    jax_model, variables = _jax_model('zero_states')
    state = {k: v.numpy() for k, v in state_dict_from_flax(variables).items()}
    arrays = ranks.write_inputs(tmp_path / 'inputs.npz', {'zero_states': state})
    spawn(ranks.points_refusal_rank, 4, str(tmp_path / 'inputs.npz'), str(tmp_path / 'out.npz'),
          30)
    errors = list(np.load(tmp_path / 'out.npz')['errors'])
    assert errors == ['PointsShard: 30 points do not divide over 4 ranks'] * 4, errors
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.mesh = jax_make_mesh_2d(1, 4)
    gt = {k[3:]: v for k, v in arrays.items() if k.startswith('gt.')}
    with pytest.raises(ValueError, match='divisible by 4'):
        jt._place_batch({'features': arrays['features'][:, :30], 'ground_truth': gt})


@pytest.mark.parametrize('shards', [2, 4])
@pytest.mark.parametrize('channels', [3, 24, 300])
def test_kernel_ranking_on_shards_equals_the_whole_cloud(channels, shards):
    """The ring's 'kernel' ranking, driven over the shards in one process:
    each (query shard, key shard) block of distances is the whole cloud's
    block of `edgeconv_sq_dists` (the function the fused layer's and
    knn_gather's plain versions rank by), the ids are `edgeconv_select`'s
    and the rows knn_gather's (exact up to 16 channels, the split rows
    beyond; the bf16 mode's cotangent truncated)."""
    B, N, k = 2, 64, 9
    x = torch.from_numpy(np.random.default_rng(channels + shards).normal(
        size=(B, N, channels)).astype(np.float32))
    S = N // shards
    whole = edgeconv_sq_dists(x, x)
    ids, _ = edgeconv_select(x, k)
    for me in range(shards):
        q = x[:, me * S:(me + 1) * S]
        acc = _ring_init(q, k, shards)
        for step in range(shards):
            src = (me - step) % shards
            keys = x[:, src * S:(src + 1) * S]
            np.testing.assert_allclose(edgeconv_sq_dists(q, keys),
                                       whole[:, me * S:(me + 1) * S, src * S:(src + 1) * S],
                                       rtol=1e-6, atol=1e-6)
            acc = _ring_merge(q, keys, src, acc, me, ranking='kernel')
        nbr, idx = _ring_output(q, acc, me)
        assert torch.equal(idx, ids[:, me * S:(me + 1) * S])
        for value_chunks in (2, 1):
            rows = low_precision_rows(nbr, value_chunks)
            flat = idx + (torch.arange(B) * N)[:, None, None]
            expect = gathered_rows(x, value_chunks).reshape(B * N, -1)[flat]
            expect[:, :, 0] = q
            assert torch.equal(rows, expect)
    # the rows' cotangent, as knn_gather's backward adds it: f32 (value_chunks
    # 2) or truncated to bf16 (1) at any C
    nbr = x[:, :S, None].expand(B, S, 3, channels).clone().requires_grad_()
    g = torch.randn(B, S, 3, channels, generator=torch.Generator().manual_seed(1))
    for value_chunks in (2, 1):
        (grad,) = torch.autograd.grad(low_precision_rows(nbr, value_chunks), nbr, g)
        assert torch.equal(grad[:, :, 1:], truncate_bf16(g[:, :, 1:]) if value_chunks == 1
                           else g[:, :, 1:])
        assert torch.equal(grad[:, :, 0], g[:, :, 0])


def test_dryrun_multichip_four_ranks(capfd):
    """The dry run on 4 gloo ranks: the DP step, the sharded encoder, the
    ring on a 2 x 2 mesh and the 2 x 2 training step, whose loss is within
    1e-3 of the DP step's."""
    dryrun_multichip(4, device='cpu')
    out = capfd.readouterr().out
    assert 'dryrun_multichip::2d-mesh ok' in out and 'dryrun_multichip::ok' in out
