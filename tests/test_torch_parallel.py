"""The port's data parallelism and ring (garment_pattern_estimation_torch/
parallel/) against one process and against the JAX package, on the CPU.

Gloo ranks are spawned (`parallel.dryrun.spawn`, a FileStore rendezvous
under a temporary directory) and run the functions of
tests/torch_parallel_ranks.py, which imports no JAX: this process computes
the JAX oracles and the one-process references, and hands the ranks their
inputs as `.npz`. Two spawns: 2 ranks (the data-parallel steps, the ring
at P = 2, the mesh helpers) and 4 ranks (the ring at P = 4, the sharded
encoder on 4 point shards and on a 2 x 2 data x points mesh).

The DP step (`trainer.mesh: {data: 2}`) runs a B = 5 batch padded to 6
(tests/test_multichip.py's remainder case). Its reference is the port's
one-process step on the padded batch, sliced to the 5 real clouds before
the loss, as the JAX step over a mesh slices inside the step. Tolerances:
  * first-step gradient within 1e-5 of its norm, two steps' losses and the
    eval loss within 1e-5 relative: f32 sums of the two ranks' shares in
    another order (a gradient counted twice, or halved, is off by its norm);
  * against the JAX step over `make_mesh(2)` (use_pallas=True: the Pallas
    kernels in interpret mode, whose ranking the port's plain versions
    repeat), 1e-5 relative;
  * the ring's ids equal to the JAX ring's, its rows within 1e-6 (copies);
    the sharded encoder within 2e-4 of the JAX one (tests/test_ring.py's
    bar).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec

import torch_parallel_ranks as ranks
from garment_pattern_estimation_tpu.models import build_model as jax_build_model
from garment_pattern_estimation_tpu.models.blocks import EdgeConv as JaxEdgeConv
from garment_pattern_estimation_tpu.models.blocks import MLP as JaxMLP
from garment_pattern_estimation_tpu.parallel import (
    make_mesh as jax_make_mesh, make_mesh_2d as jax_make_mesh_2d,
    pad_batch_to_multiple as jax_pad, shard_batch as jax_shard_batch)
from garment_pattern_estimation_tpu.parallel.ring import (
    POINTS_AXIS, make_points_mesh as jax_points_mesh, ring_knn_gather as jax_ring,
    sharded_encoder_step as jax_encoder)
from garment_pattern_estimation_tpu.train.trainer import Trainer as JaxTrainer
from garment_pattern_estimation_torch.models import state_dict_from_flax
from garment_pattern_estimation_torch.models.flax_import import _mlp
from garment_pattern_estimation_torch.parallel.dryrun import spawn
from garment_pattern_estimation_torch.train import Trainer

torch.set_num_threads(1)

REL = 1e-5


@pytest.fixture(scope='module')
def dp(tmp_path_factory):
    """The DP ranks' results, the inputs, the JAX model and its variables,
    and the one-process references of each case."""
    tmp = tmp_path_factory.mktemp('dp')
    jax_model = jax_build_model('GarmentSegmentPattern3D', ranks.DATA, ranks.NN, ranks.LOSS,
                                use_pallas=True)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(jax_model.init_variables)(
        jax.random.PRNGKey(0), jnp.zeros((2, ranks.N, 3), jnp.float32)))
    states = {'zero_states': {k: v.numpy() for k, v in state_dict_from_flax(variables).items()},
              'drawn': ranks.port_state('drawn')}
    states['chunked'] = states['drawn']
    arrays = ranks.write_inputs(tmp / 'inputs.npz', states)
    spawn(ranks.dp_rank, 2, str(tmp / 'inputs.npz'), str(tmp / 'out.npz'))
    batch = ranks.batch_of(arrays)
    oracles = {case: ranks.padded_oracle(case, states[case], batch, 2) for case in ranks.CASES}
    gt = {k[3:]: v for k, v in arrays.items() if k.startswith('gt.')}
    return (dict(np.load(tmp / 'out.npz')), batch, states, oracles,
            (jax_model, variables, arrays['features'], gt))


@pytest.mark.parametrize('case', list(ranks.CASES))
def test_dp_step_gradient_equals_one_process(dp, case):
    """The 2-rank gradient is the one-process gradient on the padded batch:
    summed over the ranks once (x2 or x0.5 is off by the whole norm)."""
    out, _, _, oracles, _ = dp
    gap, same_names = ranks.gradient_gap(out, case, oracles[case][1])
    assert same_names and gap <= REL, (case, gap)
    assert bool(out[f'{case}.same_params'])


@pytest.mark.parametrize('case', list(ranks.CASES))
def test_dp_losses_equal_one_process(dp, case):
    """Two steps' losses and the eval loss of the remainder batch."""
    out, _, _, oracles, _ = dp
    losses, _, eval_loss = oracles[case]
    np.testing.assert_allclose([out[f'{case}.loss0'], out[f'{case}.loss1']], losses, rtol=REL)
    np.testing.assert_allclose(out[f'{case}.eval'], eval_loss, rtol=REL)


def _jax_trainer(mesh):
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.mesh, jt._step_cache, jt._monitor_needs_quality = mesh, {}, False
    jt.setup = dict(ranks.SETUP)
    return jt


def test_dp_losses_match_jax_mesh(dp):
    """The zero-state case's two step losses and eval loss against the JAX
    trainer's steps over `make_mesh(2)` from the same weights."""
    out, _, _, _, (jax_model, variables, features, gt) = dp
    jt = _jax_trainer(jax_make_mesh(2))
    tx = jt._make_optimizer(ranks.STEPS_PER_EPOCH)
    placed, real = jt._place_batch({'features': features, 'ground_truth': gt})
    assert real == ranks.B and placed['features'].shape[0] == 6
    params = jax.tree_util.tree_map(jnp.array, variables['params'])
    stats = jax.tree_util.tree_map(jnp.array, variables['batch_stats'])
    opt_state = tx.init(params)
    step = jt._train_step_fn(jax_model, tx, (False, False), real)
    losses = []
    for i in range(2):
        params, stats, opt_state, loss, _ = step(params, stats, opt_state, placed,
                                                 jax.random.PRNGKey(i))
        losses.append(float(loss))
    np.testing.assert_allclose([out['zero_states.loss0'], out['zero_states.loss1']], losses,
                               rtol=REL)
    eval_loss, _ = jt._eval_step_fn(jax_model, (False, False), real)(
        params, stats, placed, jax.random.PRNGKey(7))
    np.testing.assert_allclose(out['zero_states.eval'], float(eval_loss), rtol=REL)


def test_remainder_eval_loss_is_the_real_batch(dp):
    """tests/test_multichip.py's remainder check: the 2-rank eval loss of a
    batch of 5 padded to 6 is the one-process eval loss of the 5 clouds
    (zero LSTM states, running statistics), from the initial weights."""
    out, batch, states, _, _ = dp
    model = ranks.build('zero_states', states['zero_states'])
    trainer = Trainer(dict(ranks.SETUP, mesh=None), device='cpu')
    loss, _ = trainer.eval_step(model, batch, 0, torch.Generator().manual_seed(1))
    np.testing.assert_allclose(out['zero_states.eval_init'], float(loss), rtol=REL)


def _jax_ring(x, k, shards):
    run = jax.jit(jax.shard_map(
        functools.partial(jax_ring, k=k, axis_size=shards), mesh=jax_points_mesh(shards),
        in_specs=PartitionSpec(None, POINTS_AXIS, None),
        out_specs=(PartitionSpec(None, POINTS_AXIS, None, None),
                   PartitionSpec(None, POINTS_AXIS, None))))
    nbr, idx = run(jnp.asarray(x))
    return np.asarray(nbr), np.asarray(idx)


def _jax_layer(x, widths, k, seed):
    """A JAX EdgeConv layer's variables, its unsharded eval output, and its
    MLP bound for `sharded_encoder_step` (jitted: eager JAX takes tens of
    seconds here)."""
    layer = JaxEdgeConv(widths, k=k, use_pallas=False)
    v = jax.jit(lambda x: layer.init({'params': jax.random.PRNGKey(seed)}, x, train=False))(x)
    mlp = JaxMLP(widths)

    def apply(edge):
        return mlp.apply({'params': v['params']['MLP_0'],
                          'batch_stats': v['batch_stats']['MLP_0']}, edge, train=False)
    return v, jax.jit(lambda x: layer.apply(v, x, train=False))(x), apply


def _port_layer_state(v):
    sd = {}
    _mlp(sd, 'nn', v['params']['MLP_0'], v['batch_stats']['MLP_0'])
    return {k: v.numpy() for k, v in sd.items()}


HELPERS = {'features': np.arange(5 * 4 * 3, dtype=np.float32).reshape(5, 4, 3),
           'labels': np.arange(5, dtype=np.int64)}


def _ring_run(world, tmp_path_factory):
    """The ranks' results on `world` ranks, with the inputs and the JAX
    encoder's outputs."""
    tmp = tmp_path_factory.mktemp(f'ring{world}')
    rng = np.random.default_rng(42)
    arrays = {f'ring{i}': rng.normal(size=(b, n, c)).astype(np.float32)
              for i, (b, n, c, _) in enumerate(ranks.RING)}
    arrays.update({f'helpers.{k}': v for k, v in HELPERS.items()})
    jax_outputs = {}
    if world == 4:
        x = jnp.asarray(rng.normal(size=(2, 64, 3)).astype(np.float32))
        v0, h0, apply0 = _jax_layer(x, [16, 12], 4, 0)
        v1, _, apply1 = _jax_layer(h0, [16, 8], 4, 1)
        arrays['enc.x'] = np.asarray(x)
        arrays.update({f'enc0.{k}': v for k, v in _port_layer_state(v0).items()})
        arrays.update({f'enc1.{k}': v for k, v in _port_layer_state(v1).items()})
        mesh = jax_points_mesh(4)
        jax_outputs['enc'] = jax.jit(lambda x: jax_encoder(mesh, [apply0, apply1], x, 4))(x)
        x2 = jnp.asarray(rng.normal(size=(4, 32, 3)).astype(np.float32))
        v2, _, apply2 = _jax_layer(x2, [12, 8], 3, 0)
        arrays['enc2d.x'] = np.asarray(x2)
        arrays.update({f'enc2d_layer.{k}': v for k, v in _port_layer_state(v2).items()})
        mesh2d = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ('data', POINTS_AXIS))
        jax_outputs['enc2d'] = jax.jit(
            lambda x: jax_encoder(mesh2d, [apply2], x, 3, data_axis='data'))(x2)
    np.savez(tmp / 'inputs.npz', **arrays)
    spawn(ranks.ring_rank, world, str(tmp / 'inputs.npz'), str(tmp / 'out.npz'))
    return world, arrays, dict(np.load(tmp / 'out.npz')), jax_outputs


@pytest.fixture(scope='module')
def ring2(tmp_path_factory):
    return _ring_run(2, tmp_path_factory)


@pytest.fixture(scope='module')
def ring4(tmp_path_factory):
    return _ring_run(4, tmp_path_factory)


@pytest.mark.parametrize('case', range(len(ranks.RING)),
                         ids=[f'{b}x{n}x{c}_k{k}' for b, n, c, k in ranks.RING])
@pytest.mark.parametrize('world', [2, 4], ids=['P2', 'P4'])
def test_ring_knn_gather_matches_jax_ring(request, world, case):
    world, arrays, out, _ = request.getfixturevalue(f'ring{world}')
    nbr, idx = _jax_ring(arrays[f'ring{case}'], ranks.RING[case][3], world)
    np.testing.assert_array_equal(out[f'ring{case}.idx'], idx)
    np.testing.assert_allclose(out[f'ring{case}.nbr'], nbr, rtol=1e-6, atol=1e-6)
    assert (out[f'ring{case}.idx'][:, :, 0] == np.arange(idx.shape[1])).all()   # self first


@pytest.mark.parametrize('world', [2, 4], ids=['P2', 'P4'])
def test_mesh_helpers_match_jax(request, world):
    """pad_batch_to_multiple, the rows of shard_batch on each rank and
    replicate, against the JAX package's helpers over as many devices."""
    world, _, out, _ = request.getfixturevalue(f'ring{world}')
    padded, real = jax_pad(dict(HELPERS), world)
    assert int(out['pad.real']) == real == 5 and len(padded['labels']) % world == 0
    mesh = jax_make_mesh(world)
    for key, value in padded.items():
        np.testing.assert_array_equal(out[f'pad.{key}'], value)
        placed = jax_shard_batch(mesh, {key: value})[key]
        shards = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
        for r, device in enumerate(mesh.devices.flatten()):
            np.testing.assert_array_equal(out[f'shard.{key}'][r], shards[device])
    assert bool(out['replicated'])


def test_sharded_encoder_matches_jax(ring4):
    """4 point shards, two layers, and a 2 x 2 data x points mesh, one layer:
    the per-point features and the global mean pool against the JAX
    `sharded_encoder_step`; and the 2-D mesh's point slices against JAX's
    `shard_batch` on a 2 x 2 mesh."""
    _, arrays, out, jax_outputs = ring4
    h, pooled = (np.asarray(a) for a in jax_outputs['enc'])
    np.testing.assert_allclose(out['enc.h'], h, rtol=2e-4, atol=2e-4)
    for r in range(4):
        np.testing.assert_allclose(out['enc.pooled'][r], pooled, rtol=2e-4, atol=2e-4)

    h, pooled = (np.asarray(a) for a in jax_outputs['enc2d'])
    for r in range(4):
        d, p = divmod(r, 2)
        np.testing.assert_allclose(out['enc2d.h'][r], h[2 * d:2 * d + 2, 16 * p:16 * p + 16],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(out['enc2d.pooled'][r], pooled[2 * d:2 * d + 2],
                                   rtol=2e-4, atol=2e-4)
    mesh = jax_make_mesh_2d(2, 2)
    placed = jax_shard_batch(mesh, {'features': arrays['enc2d.x']})['features']
    shards = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    labels = np.arange(arrays['enc2d.x'].shape[0] * 32).reshape(-1, 32)
    for r, device in enumerate(mesh.devices.flatten()):
        np.testing.assert_array_equal(out['shard2d.features'][r], shards[device])
        # the per-point ground truth keeps the same rows and points
        d, p = divmod(r, 2)
        np.testing.assert_array_equal(out['shard2d.segmentation'][r],
                                      labels[2 * d:2 * d + 2, 16 * p:16 * p + 16])
