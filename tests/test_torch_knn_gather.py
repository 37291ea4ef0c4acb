"""The port's knn_gather and sparsemax gradients against the JAX package's.

knn_gather: the plain port (the CPU path of `knn_gather`, with its
`index_add_` backward) against the JAX Pallas kernels run in interpret
mode, at the shapes of tests/test_knn_gather.py. Ids must be equal; values
within 1e-6 (both copy the same f32 rows or the same truncation chunks);
gradients of a nonlinear readout within rtol 1e-4 / atol 3e-4: the JAX
backward scatters the cotangent as two bf16 truncation chunks (residual
about 2^-16 of |g|), the port scatters it at full f32, and the two sum in
another order.

value_chunks=1 (the bf16 compute mode): both backwards scatter the slots
>= 1 truncated to their top bf16 chunk, slot 0 at full f32, at the same
bars. Fed the same cotangent, the two agree within 2e-6 (measured at
C = 24 and 40; the port's earlier full-f32 scatter was 0.066 off at
C = 40). Through the tanh readout each side computes its own cotangent,
and a 1-ulp difference of XLA's and torch's tanh can flip one truncation,
moving that element by 2^-8 of itself: at C = 24 the readout's gap is
9.1e-5, at C = 40 one flip makes it 0.0107, so C = 40 is held on the
shared cotangent.

EdgeConv in train mode (knn_gather, the edge MLP's edge_pair first layer,
batch statistics folded, max over the slots) against the JAX module with
use_pallas=True: output and updated running statistics within 1e-5 of
their scale, parameter and input gradients within 1e-4 of their scale
(f32 sums in another order; the JAX backward's bf16 cotangent chunks).

Sparsemax: the custom backward and the Fenchel-Young loss's gradient
against `jax.vjp` of the JAX functions, to 1e-5 relative / 1e-6 absolute
(f32 sums in another order); the loss value to 1e-5 absolute (see there).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from garment_pattern_estimation_tpu.models.blocks import EdgeConv as JaxEdgeConv
from garment_pattern_estimation_tpu.ops.knn_gather import knn_gather as jax_knn_gather
from garment_pattern_estimation_tpu.ops.sparsemax import (
    sparsemax as jax_sparsemax, sparsemax_loss as jax_sparsemax_loss)
from garment_pattern_estimation_torch.models.blocks import EdgeConv
from garment_pattern_estimation_torch.models.flax_import import _mlp
from garment_pattern_estimation_torch.ops import knn_gather
from garment_pattern_estimation_torch.ops.sparsemax import sparsemax, sparsemax_loss

torch.set_num_threads(1)


def _readout_loss_jax(x, w, k, value_chunks):
    nbr, _ = jax_knn_gather(x, k, True, value_chunks)
    return jnp.sum(jnp.tanh(nbr @ w) ** 2)


@pytest.mark.parametrize('n_points,c', [
    (100, 3), (200, 12), (130, 7),   # small C: exact per-dimension path
    (120, 24),                       # wide C: truncation-split path
])
def test_forward_and_gradient_match_jax_kernel(rng, n_points, c):
    x = rng.normal(size=(2, n_points, c)).astype(np.float32)
    w = rng.normal(size=(c,)).astype(np.float32)
    ref_nbr, ref_idx = jax_knn_gather(jnp.asarray(x), 5, True)
    ref_dx = jax.grad(_readout_loss_jax)(jnp.asarray(x), jnp.asarray(w), 5, 2)

    xt = torch.from_numpy(x).requires_grad_(True)
    before = dict(knn_gather.launches)
    nbr, idx = knn_gather.knn_gather(xt, 5)
    torch.sum(torch.tanh(nbr @ torch.from_numpy(w)) ** 2).backward()
    assert knn_gather.launches == before          # the CPU takes the plain version

    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(nbr.detach().numpy(), np.asarray(ref_nbr), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), rtol=1e-4, atol=3e-4)


def test_single_chunk_forward_matches_jax_kernel(rng):
    """value_chunks=1 gathers the top truncation chunk of wide rows."""
    x = rng.normal(size=(2, 120, 24)).astype(np.float32)
    ref_nbr, ref_idx = jax_knn_gather(jnp.asarray(x), 5, True, 1)
    nbr, idx = knn_gather.knn_gather(torch.from_numpy(x), 5, value_chunks=1)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(ref_nbr))


@pytest.mark.parametrize('n_points,c', [
    (100, 3), (200, 12),             # small C: the backward truncates there too
    (120, 24), (120, 40),            # wide C
])
def test_single_chunk_gradient_matches_jax_kernel(rng, n_points, c):
    """Fault C2: with value_chunks=1 the JAX backward adds slots >= 1 as
    their top bf16 truncation chunk; the port does the same. Both get the
    same cotangent, which is not bf16-valued."""
    x = rng.normal(size=(2, n_points, c)).astype(np.float32)
    g = rng.normal(size=(2, 5, n_points, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jax_knn_gather(v, 5, True, 1)[0], jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    nbr, _ = knn_gather.knn_gather(xt, 5, value_chunks=1)
    nbr.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), rtol=1e-4, atol=3e-4)


def test_single_chunk_readout_gradient_matches_jax_kernel(rng):
    """The tanh readout of test_forward_and_gradient_match_jax_kernel at
    value_chunks=1, wide C, each side computing its own cotangent."""
    x = rng.normal(size=(2, 120, 24)).astype(np.float32)
    w = rng.normal(size=(24,)).astype(np.float32)
    ref_dx = jax.grad(_readout_loss_jax)(jnp.asarray(x), jnp.asarray(w), 5, 1)
    xt = torch.from_numpy(x).requires_grad_(True)
    nbr, _ = knn_gather.knn_gather(xt, 5, value_chunks=1)
    torch.sum(torch.tanh(nbr @ torch.from_numpy(w)) ** 2).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), rtol=1e-4, atol=3e-4)


def test_slot_zero_is_the_query_row(rng):
    x = torch.from_numpy(rng.normal(size=(1, 64, 24)).astype(np.float32))
    nbr, idx = knn_gather.knn_gather(x, 3)
    np.testing.assert_array_equal(idx[0, :, 0].numpy(), np.arange(64))
    assert torch.equal(nbr[:, 0], x)


def test_backward_reference_is_the_transposed_gather(rng):
    """dx[i] = g[slot 0 of i] + sum of g over the (query, slot) pairs that
    picked i, on ids with heavy repetition."""
    B, k, N, C = 2, 4, 30, 5
    idx = torch.from_numpy(rng.integers(0, N, size=(B, N, k)))
    idx[:, :, 0] = torch.arange(N)
    g = torch.from_numpy(rng.normal(size=(B, k, N, C)).astype(np.float32))
    expect = np.zeros((B, N, C), np.float64)
    for b in range(B):
        for n in range(N):
            for s in range(k):
                expect[b, idx[b, n, s]] += g[b, s, n].numpy()
    dx = knn_gather.knn_gather_backward_reference(idx, g)
    np.testing.assert_allclose(dx.numpy(), expect, rtol=1e-5, atol=1e-6)


def test_single_chunk_backward_reference_truncates_slots_above_zero(rng):
    """value_chunks=1: slot 0 adds its f32 cotangent, every other slot the
    cotangent with its low 16 bits cleared (truncated, not rounded)."""
    B, k, N, C = 2, 4, 30, 5
    idx = torch.from_numpy(rng.integers(0, N, size=(B, N, k)))
    idx[:, :, 0] = torch.arange(N)
    g = torch.from_numpy(rng.normal(size=(B, k, N, C)).astype(np.float32))
    g_np = g.numpy()
    truncated = (g_np.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    assert not np.array_equal(truncated, g_np)
    expect = np.zeros((B, N, C), np.float64)
    for b in range(B):
        for n in range(N):
            for s in range(k):
                expect[b, idx[b, n, s]] += (g_np if s == 0 else truncated)[b, s, n]
    dx = knn_gather.knn_gather_backward_reference(idx, g, value_chunks=1)
    np.testing.assert_allclose(dx.numpy(), expect, rtol=1e-5, atol=1e-6)


def test_k_above_n_raises():
    with pytest.raises(ValueError, match='exceeds the point count'):
        knn_gather.knn_gather(torch.zeros(1, 4, 3), 5)


def _assert_close_to_scale(ours, theirs, rel):
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    assert ours.shape == theirs.shape
    assert np.abs(ours - theirs).max() <= rel * np.abs(theirs).max()


@pytest.mark.parametrize('c', [3, 24])
def test_edgeconv_train_mode_matches_jax(rng, c):
    x = rng.normal(size=(2, 150, c)).astype(np.float32)
    jax_layer = JaxEdgeConv([24, 24, 16], k=5, use_pallas=True)
    variables = jax.tree_util.tree_map(np.asarray, jax_layer.init(
        {'params': jax.random.PRNGKey(1)}, jnp.asarray(x), train=True))

    def jax_loss(params, xx):
        out, mutated = jax_layer.apply(
            {'params': params, 'batch_stats': variables['batch_stats']}, xx,
            train=True, mutable=['batch_stats'])
        return jnp.sum(jnp.tanh(out) ** 2), (out, mutated['batch_stats'])

    (_, (ref_out, ref_stats)), (ref_gp, ref_gx) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(variables['params'], jnp.asarray(x))

    layer = EdgeConv(c, [24, 24, 16], k=5).train()
    state = {}
    _mlp(state, 'nn', variables['params']['MLP_0'], variables['batch_stats']['MLP_0'])
    layer.load_state_dict(state)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = layer(xt)
    torch.sum(torch.tanh(out) ** 2).backward()

    _assert_close_to_scale(out.detach().numpy(), ref_out, 1e-5)
    new_stats, grads = {}, {}
    _mlp(new_stats, 'nn', variables['params']['MLP_0'], ref_stats['MLP_0'])
    _mlp(grads, 'nn', ref_gp['MLP_0'], ref_stats['MLP_0'])
    for name, value in layer.state_dict().items():
        if 'running' in name:
            _assert_close_to_scale(value.numpy(), new_stats[name].numpy(), 1e-5)
    for name, param in layer.named_parameters():
        _assert_close_to_scale(param.grad.numpy(), grads[name].numpy(), 1e-4)
    _assert_close_to_scale(xt.grad.numpy(), ref_gx, 1e-4)


@pytest.mark.parametrize('n_classes', [23, 100])
def test_sparsemax_backward_matches_jax_vjp(rng, n_classes):
    z = (rng.normal(size=(3, 40, n_classes)) * 3).astype(np.float32)
    z[0, 0, :3] = z[0, 0, 3]                 # a tie group
    g = rng.normal(size=z.shape).astype(np.float32)
    _, vjp = jax.vjp(jax_sparsemax, jnp.asarray(z))
    (ref,) = vjp(jnp.asarray(g))
    zt = torch.from_numpy(z).requires_grad_(True)
    sparsemax(zt).backward(torch.from_numpy(g))
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_sparsemax_loss_and_gradient_match_jax(rng):
    z = (rng.normal(size=(200, 23)) * 2).astype(np.float32)
    labels = rng.integers(0, 23, size=200)
    ref, vjp = jax.vjp(lambda v: jax_sparsemax_loss(v, jnp.asarray(labels)), jnp.asarray(z))
    (ref_grad,) = vjp(jnp.ones_like(ref))
    zt = torch.from_numpy(z).requires_grad_(True)
    loss = sparsemax_loss(zt, torch.from_numpy(labels))
    loss.sum().backward()
    # the loss is a difference of sums of squares of size up to ~20: f32
    # rounding in another order moves it by up to ~1e-5 absolute
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(ref_grad), rtol=1e-5, atol=1e-6)
    # the loss's gradient is sparsemax(z) - onehot(y)
    onehot = np.eye(23, dtype=np.float32)[labels]
    np.testing.assert_allclose(zt.grad.numpy(), sparsemax(zt.detach()).numpy() - onehot,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('n_points,k,C,value_chunks,hub', [
    (31, 5, 3, 2, False), (33, 8, 24, 1, False), (64, 1, 7, 2, False),
    (40, 5, 6, 2, True), (40, 4, 6, 1, True)])
def test_backward_ordered_sums_in_kernel_order(rng, n_points, k, C, value_chunks, hub):
    """`knn_gather_backward_ordered`, the card's oracle of order: bitwise
    equal to a loop that adds, per target, slot 0 and then every entry
    e = n (k-1) + s - 1 naming it in ascending e (one f32 add at a time,
    slots >= 1 truncated at value_chunks=1), and within 1e-5 of the plain
    index_add_ version; a hub named in every slot >= 1 included."""
    B = 2
    idx = rng.integers(0, n_points, size=(B, n_points, k))
    if hub:
        idx[:] = n_points // 3
    idx[:, :, 0] = np.arange(n_points)
    g = rng.normal(size=(B, k, n_points, C)).astype(np.float32)
    rows = g if value_chunks == 2 else (g.view(np.uint32) & 0xFFFF0000).view(np.float32)
    expected = g[:, 0].copy()
    for b in range(B):
        for e in range(n_points * (k - 1)):
            n, s = divmod(e, k - 1)
            target = idx[b, n, s + 1]
            expected[b, target] = expected[b, target] + rows[b, s + 1, n]
    got = knn_gather.knn_gather_backward_ordered(torch.from_numpy(idx), torch.from_numpy(g),
                                                 value_chunks).numpy()
    np.testing.assert_array_equal(got, expected)
    ref = knn_gather.knn_gather_backward_reference(torch.from_numpy(idx), torch.from_numpy(g),
                                                   value_chunks).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
