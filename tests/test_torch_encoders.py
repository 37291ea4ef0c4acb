"""The port's alternative encoders against the JAX package's, on the same
inputs from `np.random.default_rng` and the same weights: `pairwise_sq_dists`,
`farthest_point_sampling`, `SetAbstraction`, `PointNetPlusPlus`,
`DynamicGraphPool`, `EdgeConvPoolingFeatures`, `EdgeConvFeatures` with graph
pooling, the mean and add EdgeConv aggregations (the `knn_gather` route and
the chunked sweeps). tests/test_torch_variants.py runs both shape models
with each variant.

The JAX side: a module is initialized with use_pallas=False (the same
variables, sooner) and applied, jitted, with use_pallas=True, so its
EdgeConv layers run the Pallas kernels in interpret mode, whose ranking and
truncations the port's plain versions repeat. `DynamicGraphPool` calls
`knn_search` without `interpret` (tpu/models/blocks.py:391), which on the
CPU cannot run the Pallas kernel: the `pallas_pool_knn` fixture hands that
call the interpret flag, as the JAX EdgeConv passes it. The module test of
the pool builds it with use_pallas=False (`knn_xla`), as the JAX package's
own pool tests do. BN statistics are perturbed so every fold does work.
Widths are small (EConv 16/24, 24-32 wide pools, <= 150 points).

Tolerances, relative to each output's largest magnitude:
  * `pairwise_sq_dists`: 1e-5 (f32 norms and product, another sum order);
  * FPS ids and the radius neighbourhoods: exact, ties included (the lower
    id first, as argmax and jax.lax.top_k order them); the pool's kept ids:
    the same set, and the same order where fitness values tie exactly (two
    points with the same neighbour set have one fitness in exact arithmetic,
    which each side rounds in its own sum order, so such a pair may swap);
  * outputs through EdgeConv layers: 1e-2 at most, 1e-4 on average (the
    edge MLP truncates activations to bf16, and a 1-ulp difference in f32
    sum order can flip one truncation), as tests/test_torch_model.py;
  * paths with no bf16 rounding (the pool, set abstraction, PointNet++):
    1e-5, and their gradients 1e-4 (f32 sums in another order);
  * BN running statistics after a train forward: 1e-5 of each buffer's
    largest magnitude.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from garment_pattern_estimation_tpu.models import blocks as jax_blocks
from garment_pattern_estimation_tpu.ops.knn import knn_xla, pairwise_sq_dists as jax_sq_dists
from garment_pattern_estimation_torch.models import blocks
from garment_pattern_estimation_torch.models.flax_import import _encoder, _graph_pool, _mlp
from garment_pattern_estimation_torch.ops.knn import pairwise_sq_dists

torch.set_num_threads(1)


def assert_close(out, ref, max_rel=1e-2, mean_rel=1e-4):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = float(np.abs(ref).max())
    diff = np.abs(out - ref)
    assert diff.max() <= max_rel * scale, (diff.max(), scale)
    assert diff.mean() <= mean_rel * scale, (diff.mean(), scale)


def assert_exact_path(out, ref, rel=1e-5):
    assert_close(out, ref, rel, rel)


@pytest.fixture()
def pallas_pool_knn(monkeypatch):
    """The JAX pool's kNN in interpret mode where the module asks for Pallas."""
    original = jax_blocks.knn_search

    def knn_search(points, k, use_pallas=None, **kwargs):
        if use_pallas and 'interpret' not in kwargs:
            kwargs['interpret'] = True
        return original(points, k, use_pallas=use_pallas, **kwargs)

    monkeypatch.setattr(jax_blocks, 'knn_search', knn_search)


def perturbed(variables, rng):
    """numpy variables with every BN statistic moved (var up by 0.1-0.5)."""
    def perturb(tree):
        return {k: perturb(v) if isinstance(v, dict) else
                v + (rng.uniform(0.1, 0.5, v.shape) if k == 'var'
                     else 0.1 * rng.normal(size=v.shape)).astype(np.float32)
                for k, v in tree.items()}
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return {'params': variables['params'],
            'batch_stats': perturb(variables.get('batch_stats', {}))}


def jax_forward(module, variables, *args, train=False):
    """(outputs, updated batch_stats or None) of the jitted apply."""
    if train:
        fn = functools.partial(module.apply, train=True, mutable=['batch_stats'])
        out, mutated = jax.jit(fn)(variables, *args)
        return out, mutated['batch_stats']
    return jax.jit(functools.partial(module.apply, train=False))(variables, *args), None


def port_forward(module, *args, train=False):
    module.train(train)
    with torch.set_grad_enabled(train):
        return module(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                        for a in args))


def assert_running_stats(port_mlp, stats, prefix=''):
    """The port MLP's running averages against JAX's updated MLP_0 stats."""
    for j, layer in enumerate(port_mlp):
        bn = stats[f'BatchNorm_{j}']
        assert_exact_path(layer[2].running_mean.numpy(), bn['mean'])
        assert_exact_path(layer[2].running_var.numpy(), bn['var'])


def grid_cloud(rng, batch, n_points, step=0.125):
    """Points on a grid of multiples of `step` in [-0.5, 0.5]^3: every
    squared distance is exact in f32, so distances tie exactly."""
    ticks = np.arange(-0.5, 0.5 + step / 2, step)
    grid = np.stack(np.meshgrid(ticks, ticks, ticks, indexing='ij'), -1).reshape(-1, 3)
    return np.stack([grid[rng.choice(len(grid), n_points, replace=False)]
                     for _ in range(batch)]).astype(np.float32)


# ---- distances and sampling ----

@pytest.mark.parametrize('D', [3, 24])
def test_pairwise_sq_dists_matches_jax(D):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, 30, D)).astype(np.float32)
    k = rng.normal(size=(2, 50, D)).astype(np.float32)
    ref = jax_sq_dists(jnp.asarray(q), jnp.asarray(k))
    out = pairwise_sq_dists(torch.from_numpy(q), torch.from_numpy(k))
    assert_exact_path(out.numpy(), ref)


@pytest.mark.parametrize('cloud', ['normal', 'grid'])
def test_farthest_point_sampling_matches_jax(cloud):
    """Exact ids; on the grid many farthest distances tie exactly and the
    first maximum wins on both sides."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 200, 3)).astype(np.float32) if cloud == 'normal' \
        else grid_cloud(rng, 2, 200)
    ref = np.asarray(jax_blocks.farthest_point_sampling(jnp.asarray(x), 40))
    out = blocks.farthest_point_sampling(torch.from_numpy(x), 40)
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize('train', [False, True])
def test_set_abstraction_matches_jax(train):
    """Grid clouds: radius neighbourhoods tie exactly (the lower id enters
    first), some hold fewer than 25 points (masked rows, which still enter
    the MLP's batch statistics) and some are capped at 25."""
    rng = np.random.default_rng(2)
    x = grid_cloud(rng, 2, 300)
    module = jax_blocks.SetAbstraction([16, 16, 24], ratio=0.2, radius=0.3)
    variables = perturbed(module.init(jax.random.PRNGKey(0), None, jnp.asarray(x)), rng)
    (ref, ref_centroids), stats = jax_forward(module, variables, None, jnp.asarray(x),
                                              train=train)
    sa = blocks.SetAbstraction(0, [16, 16, 24], ratio=0.2, radius=0.3)
    sd = {}
    _mlp(sd, 'mlp', variables['params']['MLP_0'], variables['batch_stats']['MLP_0'])
    sa.load_state_dict(sd)
    out, centroids = port_forward(sa, None, torch.from_numpy(x), train=train)
    np.testing.assert_array_equal(centroids.detach().numpy(), ref_centroids)
    assert_exact_path(out.detach().numpy(), ref)
    # the neighbourhoods the port takes: some masked, some capped, some tied
    d = pairwise_sq_dists(centroids, torch.from_numpy(x))
    inside = (d <= 0.3 ** 2).sum(-1)
    assert (inside < 25).any() and (inside > 25).any()
    if train:
        assert_running_stats(sa.mlp, stats['MLP_0'])


@pytest.mark.parametrize('train', [False, True])
def test_pointnet_matches_jax(train):
    rng = np.random.default_rng(3)
    x = grid_cloud(rng, 2, 150)
    module = jax_blocks.PointNetPlusPlus(out_size=16, econv_hidden=16, econv_feature=24)
    variables = perturbed(module.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    (ref_enc, ref_points, _), stats = jax_forward(module, variables, jnp.asarray(x),
                                                  train=train)
    net = blocks.PointNetPlusPlus(out_size=16, econv_hidden=16, econv_feature=24)
    net.load_state_dict(_encoder_state(variables))
    enc, points, _ = port_forward(net, x, train=train)
    assert points.shape == (2, 30, 24) and net.out_features == 24
    assert_exact_path(enc.detach().numpy(), ref_enc)
    assert_exact_path(points.detach().numpy(), ref_points)
    if train:
        assert_running_stats(net.sa1.mlp, stats['sa1']['MLP_0'])
        assert_running_stats(net.mlp, stats['MLP_0'])


def _encoder_state(variables):
    """An encoder module's state dict from its flax variables."""
    sd = {}
    _encoder(sd, variables['params'], variables['batch_stats'])
    return {k[len('feature_extractor.'):]: v for k, v in sd.items()}


# ---- graph pooling ----

def assert_same_selection(out, idx, ref, ref_idx):
    """The same kept ids per cloud, and their rows close, matched by id."""
    idx, ref_idx = np.asarray(idx), np.asarray(ref_idx)
    np.testing.assert_array_equal(np.sort(idx, axis=1), np.sort(ref_idx, axis=1))
    order, ref_order = np.argsort(idx, axis=1), np.argsort(ref_idx, axis=1)
    assert_exact_path(np.take_along_axis(np.asarray(out), order[..., None], 1),
                      np.take_along_axis(np.asarray(ref), ref_order[..., None], 1))


def _pool_module(feature_size, rng, x, k=10, ratio=0.25, fit_scale=1.0):
    module = jax_blocks.DynamicGraphPool(feature_size, k=k, pool_ratio=ratio,
                                         use_pallas=False)
    params = jax.tree_util.tree_map(
        np.asarray, module.init(jax.random.PRNGKey(0), jnp.asarray(x)))['params']
    params = {name: {'kernel': dense['kernel'] * (fit_scale if name != 'att' else 1.0),
                     'bias': dense['bias'] + 0.1 * rng.normal(size=1).astype(np.float32)}
              for name, dense in params.items()}
    pool = blocks.DynamicGraphPool(feature_size, k=k, pool_ratio=ratio)
    sd = {}
    _graph_pool(sd, 'p', params)
    pool.load_state_dict({key[2:]: v for key, v in sd.items()})
    return module, {'params': params}, pool


def test_dynamic_graph_pool_matches_jax():
    """The pool with its own kNN (exact ranking on both sides at D = 24),
    its ids exactly, and the gradient through the gather of the kept
    fitness values."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 60, 24)).astype(np.float32)
    module, variables, pool = _pool_module(24, rng, x)
    weights = rng.normal(size=(2, 15, 24)).astype(np.float32)

    def jax_loss(params, x):
        out, _ = module.apply({'params': params}, x)
        return jnp.sum(out * weights)

    (ref, ref_idx) = module.apply(variables, jnp.asarray(x))
    ref_grads = jax.grad(jax_loss, argnums=(0, 1))(variables['params'], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    out, idx = pool(xt)
    assert_same_selection(out.detach(), idx, ref, ref_idx)
    torch.sum(out * torch.from_numpy(weights)).backward()
    assert_exact_path(xt.grad.numpy(), ref_grads[1], 1e-4)
    for name in ('att', 'fit_self', 'fit_nbr'):
        layer = getattr(pool, name)
        assert_exact_path(layer.weight.grad.numpy().T, ref_grads[0][name]['kernel'], 1e-4)
        assert_exact_path(layer.bias.grad.numpy(), ref_grads[0][name]['bias'], 1e-4)


@pytest.mark.parametrize('D', [8, 24])
def test_dynamic_graph_pool_on_given_ids(D):
    """`pool(x, ids)` on the JAX pool's own kNN ids (`knn_xla`): the same
    kept ids and values at a width where the port's kNN would rank
    quantized distances (D <= 16) as well as at a wide one."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 60, D)).astype(np.float32)
    module, variables, pool = _pool_module(D, rng, x, k=7, ratio=0.3)
    ref, ref_idx = module.apply(variables, jnp.asarray(x))
    ids = torch.from_numpy(np.asarray(knn_xla(jnp.asarray(x), 7)).astype(np.int64))
    with torch.no_grad():
        out, idx = pool.pool(torch.from_numpy(x), ids)
    assert idx.shape == (2, 18)
    assert_same_selection(out, idx, ref, ref_idx)


def test_dynamic_graph_pool_top_k_ties():
    """Fitness saturated to exactly +1 for more clusters than are kept:
    among equal values the lower id is kept first, as jax.lax.top_k keeps
    it."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 60, 24)).astype(np.float32)
    module, variables, pool = _pool_module(24, rng, x, fit_scale=1e3)
    ref, ref_idx = module.apply(variables, jnp.asarray(x))
    terms = []
    for name in ('fit_self', 'fit_nbr'):
        getattr(pool, name).register_forward_hook(lambda m, i, o: terms.append(o[..., 0]))
    with torch.no_grad():
        out, idx = pool(torch.from_numpy(x))
    fitness = torch.tanh(terms[0] + terms[1])
    assert ((fitness == 1.0).sum(1) > pool.keep(60)).all()
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    assert_exact_path(out.numpy(), ref)


# ---- EdgeConv aggregations ----

def _edgeconv_pair(rng, x, aggr, **kwargs):
    module = jax_blocks.EdgeConv([16, 16, 24], k=5, aggr=aggr, use_pallas=True, **kwargs)
    plain = jax_blocks.EdgeConv([16, 16, 24], k=5, aggr=aggr, use_pallas=False, **kwargs)
    variables = perturbed(plain.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    conv = blocks.EdgeConv(x.shape[-1], [16, 16, 24], k=5, aggr=aggr,
                           **{'train_chunked': kwargs.get('train_chunked'),
                              'train_chunk_size': kwargs.get('train_chunk_size')})
    sd = {}
    _mlp(sd, 'nn', variables['params']['MLP_0'], variables['batch_stats']['MLP_0'])
    conv.load_state_dict(sd)
    return module, variables, conv


@pytest.mark.parametrize('aggr', ['mean', 'add'])
@pytest.mark.parametrize('C', [3, 24])
@pytest.mark.parametrize('train', [False, True])
def test_edgeconv_aggregation_matches_jax(aggr, C, train):
    """Mean and add route through knn_gather in eval as in train (the fused
    layer takes only max), on both sides."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 64, C)).astype(np.float32)
    module, variables, conv = _edgeconv_pair(rng, x, aggr)
    ref, stats = jax_forward(module, variables, jnp.asarray(x), train=train)
    out = port_forward(conv, x, train=train)
    assert_close(out.detach().numpy(), ref)
    if train:
        assert_running_stats(conv.nn, stats['MLP_0'])


def test_edgeconv_add_chunked_route_matches_jax():
    """aggr='add' through the chunked sweeps (the port names the sum 'sum'):
    output, running statistics and the MLP's gradient."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 64, 24)).astype(np.float32)
    module, variables, conv = _edgeconv_pair(rng, x, 'add', train_chunked=True,
                                             train_chunk_size=16)
    weights = rng.normal(size=(2, 64, 24)).astype(np.float32)

    def jax_loss(params):
        out, mutated = module.apply({'params': params,
                                     'batch_stats': variables['batch_stats']},
                                    jnp.asarray(x), train=True, mutable=['batch_stats'])
        return jnp.sum(out * weights), (out, mutated['batch_stats'])

    (_, (ref, stats)), grads = jax.value_and_grad(jax_loss, has_aux=True)(
        variables['params'])
    out = port_forward(conv, x, train=True)
    assert_close(out.detach().numpy(), ref)
    assert_running_stats(conv.nn, stats['MLP_0'])
    torch.sum(out * torch.from_numpy(weights)).backward()
    for j, layer in enumerate(conv.nn):
        ref_grad = grads['MLP_0'][f'Dense_{j}']['kernel']
        assert_close(layer[0].weight.grad.numpy().T, ref_grad, 1e-3, 1e-4)


def test_edgeconv_unknown_aggregation_raises():
    with pytest.raises(ValueError, match='unsupported aggregation'):
        blocks.EdgeConv(3, [8], aggr='median')


# ---- pooling encoders ----

@pytest.mark.parametrize('train', [False, True])
def test_edgeconv_pooling_features_matches_jax(pallas_pool_knn, train):
    """k = 10, 128 -> 32 -> 8 points; conv2 and conv3 on wide features."""
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 128, 3)).astype(np.float32)
    kwargs = dict(out_size=16, n_features1=24, n_features2=24, n_features3=32, k=10,
                  pool_ratio=0.25)
    module = jax_blocks.EdgeConvPoolingFeatures(**kwargs, use_pallas=True)
    plain = jax_blocks.EdgeConvPoolingFeatures(**kwargs, use_pallas=False)
    variables = perturbed(plain.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    (ref_enc, ref_points, _), stats = jax_forward(module, variables, jnp.asarray(x),
                                                  train=train)
    encoder = blocks.EdgeConvPoolingFeatures(**kwargs)
    encoder.load_state_dict(_encoder_state(variables))
    enc, points, _ = port_forward(encoder, x, train=train)
    assert points.shape == (2, 8, 32) and encoder.out_features == 32
    assert_close(enc.detach().numpy(), ref_enc)
    assert_close(points.detach().numpy(), ref_points)
    if train:
        for i in (1, 2, 3):
            assert_running_stats(getattr(encoder, f'conv{i}').nn, stats[f'conv{i}']['MLP_0'])


@pytest.mark.parametrize('train', [False, True])
def test_graph_pooling_features_matches_jax(pallas_pool_knn, train):
    """conv_depth 2: widths 8-8-12 and 16-16-24, a pool after each conv,
    128 -> 32 -> 8 points."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 128, 3)).astype(np.float32)
    kwargs = dict(out_size=16, conv_depth=2, k_neighbors=5, econv_hidden=16,
                  econv_feature=24, graph_pooling=True, pool_ratio=0.25)
    module = jax_blocks.EdgeConvFeatures(**kwargs, use_pallas=True)
    plain = jax_blocks.EdgeConvFeatures(**kwargs, use_pallas=False)
    variables = perturbed(plain.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    (ref_enc, ref_points, _), stats = jax_forward(module, variables, jnp.asarray(x),
                                                  train=train)
    encoder = blocks.EdgeConvFeatures(**kwargs)
    assert [c.mlp_features for c in encoder.conv_layers] == [[8, 8, 12], [16, 16, 24]]
    encoder.load_state_dict(_encoder_state(variables))
    enc, points, _ = port_forward(encoder, x, train=train)
    assert points.shape == (2, 8, 24)
    assert_close(enc.detach().numpy(), ref_enc)
    assert_close(points.detach().numpy(), ref_points)
    if train:
        for i, conv in enumerate(encoder.conv_layers):
            assert_running_stats(conv.nn, stats[f'conv{i}']['MLP_0'])
    with pytest.raises(ValueError, match='skip connections'):
        blocks.EdgeConvFeatures(**kwargs, skip_connections=True)
