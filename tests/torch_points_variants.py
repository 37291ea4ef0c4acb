"""The run behind tests/test_torch_parallel_points_variants*.py: each variant
of tests/torch_parallel_ranks.py's VARIANTS (max pools, the segmentation
term, graph pooling, EdgeConvPoolingFeatures, PointNet++ with even and
uneven centroid shares) trained on gloo CPU ranks over `trainer.mesh:
{data: d, points: p}` (p = 2; 4 for the first file's cases), against the port's one-process step on the padded
batch and, at {data: 1, points: 2}, against `JaxTrainer` over the JAX
package's `make_mesh_2d(1, 2)` (`use_pallas=False`, as the JAX trainer runs
a points mesh), from the JAX model's weights (`state_dict_from_flax`).

Bars, those of tests/test_torch_parallel_points.py:
  * the losses of 2 steps within rtol 2e-5 of the one process's;
  * the first step's gradient within 1e-5 of its norm, or twice the order
    floor where that is larger: the largest gap one process's gradient
    takes when the clouds are scaled by 1 + 1e-7 noise, over three draws
    (one draw may fall low: PointNet++'s {2, 2} floor reads 8.0e-6 to
    1.6e-5 over six draws; pool10's is about 7e-5, its 256-wide conv3 on 8
    pooled points). A gradient counted p times, or a points rank's share
    dropped, is off by a good part of its norm;
  * at {data: 1, points: 2}, the two losses within rtol 2e-5 of the JAX 2-D
    mesh's, and the eval loss after them (both evaluate the layers on
    whole gathered clouds with the unfused f32 layer) within rtol 2e-5 or
    twice its floor where that is larger: how far the JAX mesh's own eval
    loss moves when the clouds are scaled by 1 + 1e-7 noise or run in
    reverse order. Adam's first steps turn gradients that are zero in
    exact arithmetic (a bias before a BatchNorm) into updates of the
    learning rate's size whose sign is the rounding's, and eval, on the
    running statistics, reads them: the max_pools case's eval moves by
    3.2e-5 to 4.2e-5 of itself that way, its loss gap to the JAX mesh is
    5.5e-5. The graph-pooled cases are held to it with the stages after
    the gather on the XLA layer's semantics (`torch_parallel_ranks.
    xla_semantics`: exact distances for the pools' kNN, exact f32 rows):
    the port ranks and gathers as the kernels do, and on pool10's clouds
    of 16 points of 32 and 128 features that moves the first step's
    gradient by 0.8% of its norm (one pool neighbour of 80 and the split
    rows; 2.7e-4 with both as XLA's), and its second loss by 2.4% through
    Adam's update. Their first loss, before Adam, is also held to the JAX
    mesh's within rtol 2e-5 as the port runs it (the kernels' semantics:
    3.6e-6 for pool10, 1.8e-7 for gpool);
  * the F64_CASES (pointnet_baseline) also run in float64 on the ranks and
    in the one process (`torch_parallel_ranks.float64_semantics`), the
    losses, the eval loss and the first gradient within 1e-9 (F64_BAR) of
    the one process's: in f32 this model's gradient follows the rounding of
    its MLP pattern decoder's BatchNorm variance over 4 near-equal rows
    (one of its 1e-7-noise draws moves it by 1.0e-3 of its norm), in f64
    the sharded step reads 5e-14 of the one process's, and the all-reduce
    max's backward without its sum over the ranks moves it by a part of its
    norm.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_parallel_ranks as ranks
from garment_pattern_estimation_tpu.models import build_model as jax_build_model
from garment_pattern_estimation_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from garment_pattern_estimation_tpu.train.trainer import Trainer as JaxTrainer
from garment_pattern_estimation_torch.models import state_dict_from_flax
from garment_pattern_estimation_torch.parallel.dryrun import spawn

F64_BAR = 1e-9


def _jax_model(case):
    """The case's JAX model (`use_pallas=False`) and its seed-0 variables."""
    nn_config, loss_config, _, points, _ = ranks.VARIANTS[case]
    model = jax_build_model(ranks.model_name(case), ranks.DATA, nn_config, loss_config,
                            use_pallas=False)
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(model.init_variables)(
        jax.random.PRNGKey(0), jnp.zeros((2, points, 3), jnp.float32)))
    return model, variables


def _jax_steps(model, variables, batches):
    """JaxTrainer's two train steps and then an eval step over
    `make_mesh_2d(1, 2)` on each batch (the steps compiled once): [(the two
    losses, the eval loss)]."""
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.mesh, jt._step_cache, jt._monitor_needs_quality = jax_make_mesh_2d(1, 2), {}, False
    jt.setup = dict(ranks.SETUP)
    tx = jt._make_optimizer(ranks.STEPS_PER_EPOCH)
    runs, steps = [], None
    for batch in batches:
        placed, real = jt._place_batch({
            'features': batch['features'].numpy(),
            'ground_truth': {k: v.numpy() for k, v in batch['ground_truth'].items()}})
        assert placed['features'].sharding.spec[1] == 'points'
        if steps is None:
            steps = (jt._train_step_fn(model, tx, (False, False), real),
                     jt._eval_step_fn(model, (False, False), real))
        params = jax.tree_util.tree_map(jnp.array, variables['params'])
        stats = jax.tree_util.tree_map(jnp.array, variables['batch_stats'])
        opt_state = tx.init(params)
        losses = []
        for i in range(2):
            params, stats, opt_state, loss, _ = steps[0](params, stats, opt_state, placed,
                                                         jax.random.PRNGKey(i))
            losses.append(float(loss))
        eval_loss, _ = steps[1](params, stats, placed, jax.random.PRNGKey(7))
        runs.append((losses, float(eval_loss)))
    return runs


def run(cases, data, tmp, points=2):
    """(the ranks' results, the one-process references (also of
    '<case>+f64' for the F64_CASES), the 1e-7-noise gradient floors, and
    at {1, 2} the JAX 2-D mesh's (losses, eval loss, the eval's floor)) by
    case, at {data: `data`, points: `points`}."""
    jax_models = {case: _jax_model(case) for case in cases}
    states = {case: {k: v.numpy() for k, v in state_dict_from_flax(variables).items()}
              for case, (_, variables) in jax_models.items()}
    arrays = ranks.write_variant_inputs(tmp / 'inputs.npz', states, cases)
    np.savez(tmp / 'inputs.npz', **arrays, **{'mesh.data': np.asarray(data)})
    with_jax = (data, points) == (1, 2)
    held = [case + ranks.XLA for case in cases if case in ranks.POOL_CASES and with_jax]
    held += [case + ranks.F64 for case in cases if case in ranks.F64_CASES]
    spawn(ranks.points_rank, points * data, str(tmp / 'inputs.npz'), str(tmp / 'out.npz'),
          tuple(cases) + tuple(held))
    oracles, floors, jax_runs = {}, {}, {}
    for case in cases:
        batch = ranks.batch_of(ranks._split(arrays, f'batch.{case}.'))
        oracles[case] = ranks.padded_oracle(case, states[case], batch, data)
        if case in ranks.F64_CASES:
            oracles[case + ranks.F64] = ranks.padded_oracle(case + ranks.F64, states[case],
                                                            batch, data)
        gaps = []
        for seed in (5, 6, 7):
            noise = torch.randn(batch['features'].shape,
                                generator=torch.Generator().manual_seed(seed))
            noisy = dict(batch, features=batch['features'] * (1 + 1e-7 * noise))
            moved = ranks.padded_oracle(case, states[case], noisy, data)[1]
            gaps.append(ranks.gradient_gap(
                {f'{case}.grad.{n}': g.numpy() for n, g in moved.items()}, case,
                oracles[case][1])[0])
        floors[case] = max(gaps)
        if with_jax:
            flipped = {'features': batch['features'].flip(0),
                       'ground_truth': {k: v.flip(0) for k, v in batch['ground_truth'].items()}}
            (losses, eval_loss), *others = _jax_steps(*jax_models[case],
                                                      (batch, noisy, flipped))
            jax_runs[case] = (losses, eval_loss,
                              max(abs(e - eval_loss) / abs(eval_loss) for _, e in others))
    return dict(np.load(tmp / 'out.npz')), oracles, floors, jax_runs


def check_one_process(run_result, case):
    out, oracles, floors, _ = run_result
    losses, grads, _ = oracles[case]
    np.testing.assert_allclose([out[f'{case}.loss0'], out[f'{case}.loss1']], losses, rtol=2e-5)
    gap, same_names = ranks.gradient_gap(out, case, grads)
    assert same_names and gap <= max(1e-5, 2 * floors[case]), (case, gap, floors[case])
    assert bool(out[f'{case}.same_params'])
    assert np.isfinite(out[f'{case}.eval'])


def check_float64(run_result, case):
    out, oracles, _, _ = run_result
    key = case + ranks.F64
    losses, grads, eval_loss = oracles[key]
    np.testing.assert_allclose([out[f'{key}.loss0'], out[f'{key}.loss1'], out[f'{key}.eval']],
                               losses + [eval_loss], rtol=F64_BAR)
    gap, same_names = ranks.gradient_gap(out, key, grads)
    assert same_names and gap <= F64_BAR, (case, gap)


def check_jax_mesh(run_result, case):
    out, _, _, jax_runs = run_result
    losses, eval_loss, eval_floor = jax_runs[case]
    key = case + ranks.XLA if case in ranks.POOL_CASES else case
    np.testing.assert_allclose([out[f'{key}.loss0'], out[f'{key}.loss1']], losses, rtol=2e-5)
    np.testing.assert_allclose(out[f'{key}.eval'], eval_loss, rtol=max(2e-5, 2 * eval_floor))
    if case in ranks.POOL_CASES:
        np.testing.assert_allclose(out[f'{case}.loss0'], losses[0], rtol=2e-5)
