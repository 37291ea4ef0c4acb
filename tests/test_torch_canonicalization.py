"""The port's GT canonicalization primitives, stitch-tag loss and stitch
metrics against the JAX package's, at configs/lstm_stitch_tags.yaml's real
shapes: 4 patterns of up to 23 panels x 14 edges with up to 24 stitches
(E = 322 edges, so the decoder runs E // 2 = 161 steps).

The inputs hold the cases where the matchings tie exactly: padded GT panels
(the pad-vector outline, zero edges, equal placements), panels of 1 and 2
edges, a panel whose edges are all equal (every loop rotation fits alike),
and stitch tags shared by several edges. Both sides must take the first of
equal minima, so permutations, leading edges, renumbered stitch ids and
decoded pairs are held equal (a permutation up to the order in which two
slots as close as f32 rounding takes identical padded panels, see
test_greedy_order_match); floats to 1e-5 relative, 1e-6 absolute (f32 sums
in another order).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import DATA_CONFIG
from garment_pattern_estimation_tpu.losses import components as jax_components
from garment_pattern_estimation_tpu.losses import composed as jax_composed
from garment_pattern_estimation_tpu.losses import stitches as jax_stitches
from garment_pattern_estimation_torch.losses import components, composed, stitches

torch.set_num_threads(1)

B, P, L, S = 4, DATA_CONFIG['max_pattern_len'], DATA_CONFIG['max_panel_len'], \
    DATA_CONFIG['max_num_stitches']
E = P * L
MAX_STITCHES = E // 2


def _pad_vector():
    stats = DATA_CONFIG['standardize']
    return np.asarray(jax_components.eval_pad_vector(
        {k: stats[f'gt_{k}']['outlines'] for k in ('shift', 'scale')}))


def make_ground_truth(rng):
    """GT in the dataset's shapes: 23, 9, 3 and 14 panels; one panel each
    of 1 and 2 edges in the second pattern; an all-equal-edges panel in the
    first; padded panels hold the pad vector and zero placements; stitches
    join edges inside the loops, the padded ids are zeros."""
    num_panels = np.array([P, 9, 3, 14])
    num_edges = np.where(np.arange(P)[None] < num_panels[:, None],
                         rng.integers(3, L + 1, size=(B, P)), 0)
    num_edges[1, 2], num_edges[1, 5] = 1, 2
    outlines = rng.normal(size=(B, P, L, 4)).astype(np.float32) * 0.5
    outlines[0, 4, :num_edges[0, 4]] = outlines[0, 4, 0]          # every shift ties
    outlines = np.where((np.arange(L)[None, None] < num_edges[..., None])[..., None],
                        outlines, _pad_vector()).astype(np.float32)
    exists = (np.arange(P)[None] < num_panels[:, None])[..., None]
    rotations = np.where(exists, rng.normal(size=(B, P, 4)), 0.0).astype(np.float32)
    translations = np.where(exists, rng.normal(size=(B, P, 3)), 0.0).astype(np.float32)

    stitches = np.zeros((B, 2, S), np.int64)
    num_stitches = np.array([S, 7, 0, 12])
    free = np.ones((B, P, L), bool)
    for b in range(B):
        edges = [p * L + e for p in range(P) for e in range(num_edges[b, p])]
        chosen = rng.choice(edges, size=2 * num_stitches[b], replace=False)
        stitches[b, :, :num_stitches[b]] = chosen.reshape(2, -1)
        free.reshape(B, -1)[b, chosen] = False
    return {'outlines': outlines, 'rotations': rotations, 'translations': translations,
            'num_edges': num_edges.astype(np.int32), 'num_panels': num_panels.astype(np.int32),
            'empty_panels_mask': num_edges == 0,
            'stitches': stitches, 'num_stitches': num_stitches.astype(np.int32),
            'free_edges_mask': free,
            'stitch_tags': rng.normal(size=(B, P, L, 3)).astype(np.float32)}


def make_predictions(rng, gt):
    """Each pattern's GT panels in another order, each loop rotated, plus
    noise; stitch tags equal on the two sides of a GT stitch (a few pairs
    off), with free-edge logits that mark the stitched edges."""
    perm = np.stack([rng.permutation(P) for _ in range(B)])
    take = lambda x: np.take_along_axis(x, perm.reshape(perm.shape + (1,) * (x.ndim - 2)),
                                        axis=1)
    outlines = take(gt['outlines'])
    shift = rng.integers(0, L, size=(B, P))
    outlines = np.stack([[np.roll(outlines[b, p], -shift[b, p], axis=0) for p in range(P)]
                         for b in range(B)])
    tags = rng.normal(size=(B, E, 3)).astype(np.float32)
    for b in range(B):
        n = gt['num_stitches'][b]
        left, right = gt['stitches'][b, :, :n]
        tags[b, right[: max(n - 2, 0)]] = tags[b, left[: max(n - 2, 0)]]
    tags[2, :6] = tags[2, 0]                     # identical tags: zero distances tie
    free_logits = np.where(gt['free_edges_mask'], 2.0, -2.0) \
        + rng.normal(size=(B, P, L)) * 0.5
    free_logits[2, 0, :6] = -3.0
    noise = lambda shape: rng.normal(size=shape).astype(np.float32) * 0.05
    return {'outlines': (outlines + noise(outlines.shape)).astype(np.float32),
            'rotations': (take(gt['rotations']) + noise((B, P, 4))).astype(np.float32),
            'translations': (take(gt['translations']) + noise((B, P, 3))).astype(np.float32),
            'stitch_tags': tags.reshape(B, P, L, 3),
            'free_edges_mask': free_logits.astype(np.float32)}


@pytest.fixture(scope='module')
def data():
    rng = np.random.default_rng(2024)
    gt = make_ground_truth(rng)
    return gt, make_predictions(rng, gt)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(x)


def _equal(ours, theirs):
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs))


def _close(ours, theirs):
    np.testing.assert_allclose(np.asarray(ours, np.float64), np.asarray(theirs, np.float64),
                               rtol=1e-5, atol=1e-6)


def _order_features(tree):
    return np.concatenate([tree['translations'], tree['outlines'].reshape(B, P, -1)], -1)


def test_greedy_order_match(data):
    """Permutations equal, but where two predicted slots are equally close
    to padded GT panels within the f32 rounding of the distance expansion
    (|p|^2 + |g|^2 - 2 p.g, rounded in another order by XLA and torch):
    the two slots may then take the identical padded panels in the other
    order, which permutes the GT to the same values."""
    gt, preds = data
    pred_f, gt_f = _order_features(preds), _order_features(gt)
    ours = composed.greedy_order_match(_t(pred_f), _t(gt_f))
    theirs = np.asarray(jax_composed.greedy_order_match(_j(pred_f), _j(gt_f)))
    differ = ours.numpy() != theirs
    padded = gt['num_edges'] == 0
    assert np.take_along_axis(padded, ours.numpy(), 1)[differ].all()
    assert np.take_along_axis(padded, theirs, 1)[differ].all()
    assert differ.sum() <= 2
    _equal(composed.permute_panels(_t(gt_f), ours),
           jax_composed.permute_panels(_j(gt_f), _j(theirs)))
    assert ours.dtype == torch.int64
    assert all(sorted(row) == list(range(P)) for row in ours.tolist())
    # all-equal features tie everywhere: the first minimum each step
    # gives the identity
    flat = np.zeros((2, P, 5), np.float32)
    _equal(composed.greedy_order_match(_t(flat), _t(flat)), np.tile(np.arange(P), (2, 1)))


def test_permute_panels_and_stitch_renumbering(data):
    gt, preds = data
    perm = np.asarray(jax_composed.greedy_order_match(
        _j(_order_features(preds)), _j(_order_features(gt))))
    for key in ('outlines', 'num_edges', 'empty_panels_mask', 'rotations', 'free_edges_mask'):
        _equal(composed.permute_panels(_t(gt[key]), _t(perm)),
               jax_composed.permute_panels(_j(gt[key]), _j(perm)))
    _equal(composed.renumber_stitches_after_permute(
               _t(gt['stitches']), _t(gt['num_stitches']), _t(perm), L),
           jax_composed.renumber_stitches_after_permute(
               _j(gt['stitches'].astype(np.int32)), _j(gt['num_stitches']), _j(perm), L))


def test_match_panel_origins_and_shifts(data):
    gt, preds = data
    ours_out, ours_lead = composed.match_panel_origins(
        _t(preds['outlines']), _t(gt['outlines']), _t(gt['num_edges']))
    theirs_out, theirs_lead = jax_composed.match_panel_origins(
        _j(preds['outlines']), _j(gt['outlines']), _j(gt['num_edges']))
    _equal(ours_lead, theirs_lead)
    _equal(ours_out, theirs_out)
    assert ours_lead.reshape(B, P)[0, 4] == 0            # the all-equal panel
    assert not ours_lead.reshape(B, P)[1, 9:].any()      # padded panels
    assert ours_lead.reshape(B, P)[1, 2] == 0            # one edge: one shift

    lead = np.asarray(theirs_lead)
    for key, feats in (('free_edges_mask', gt['free_edges_mask'][..., None]),
                       ('stitch_tags', gt['stitch_tags'])):
        _equal(composed.shift_panel_features(_t(feats), _t(lead), _t(gt['num_edges'])),
               jax_composed.shift_panel_features(_j(feats), _j(lead), _j(gt['num_edges'])))
    _equal(composed.renumber_stitches_after_shift(
               _t(gt['stitches']), _t(gt['num_stitches']), _t(lead), _t(gt['num_edges']), P, L),
           jax_composed.renumber_stitches_after_shift(
               _j(gt['stitches'].astype(np.int32)), _j(gt['num_stitches']), _j(lead),
               _j(gt['num_edges']), P, L))


def test_random_permutations_from_a_generator():
    perms = composed.random_permutations(torch.Generator().manual_seed(3), B, P)
    assert perms.shape == (B, P) and perms.dtype == torch.int64
    assert all(sorted(row) == list(range(P)) for row in perms.tolist())
    again = composed.random_permutations(torch.Generator().manual_seed(3), B, P)
    assert torch.equal(perms, again)
    other = composed.random_permutations(torch.Generator().manual_seed(4), B, P)
    assert not torch.equal(perms, other)


@pytest.mark.parametrize('use_hardnet', [False, True])
def test_pattern_stitch_loss(data, use_hardnet):
    gt, preds = data
    ours, ours_terms = components.pattern_stitch_loss(
        _t(preds['stitch_tags']), _t(gt['stitches']), _t(gt['num_stitches']),
        margin=0.3, use_hardnet=use_hardnet)
    theirs, theirs_terms = jax_components.pattern_stitch_loss(
        _j(preds['stitch_tags']), _j(gt['stitches'].astype(np.int32)),
        _j(gt['num_stitches']), margin=0.3, use_hardnet=use_hardnet)
    _close(ours, theirs)
    assert sorted(ours_terms) == sorted(theirs_terms)
    for key in theirs_terms:
        _close(ours_terms[key], theirs_terms[key])
    assert float(ours_terms['stitch_neg_loss']) > 0


def test_tags_to_stitches(data):
    _, preds = data
    pairs, valid = stitches.tags_to_stitches_jit(
        _t(preds['stitch_tags']), _t(preds['free_edges_mask']), MAX_STITCHES)
    ref_pairs, ref_valid = jax.vmap(
        lambda t, s: jax_stitches.tags_to_stitches_jit(t, s, MAX_STITCHES))(
        _j(preds['stitch_tags']), _j(preds['free_edges_mask']))
    assert pairs.shape == (B, MAX_STITCHES, 2) and valid.shape == (B, MAX_STITCHES)
    _equal(valid, ref_valid)
    _equal(pairs, ref_pairs)
    assert 0 < int(valid.sum()) < B * MAX_STITCHES
    # the host decoder finds the same pairs
    for b in range(B):
        host = stitches.tags_to_stitches_np(preds['stitch_tags'][b],
                                            preds['free_edges_mask'][b])
        _equal(pairs[b][valid[b]].T, host)


@pytest.mark.parametrize('with_mask', [False, True])
def test_stitch_precision_recall(data, with_mask):
    gt, preds = data
    mask = np.array([True, True, False, True]) if with_mask else None
    ours = stitches.stitch_precision_recall(
        _t(preds['stitch_tags']), _t(preds['free_edges_mask']), _t(gt['stitches']),
        _t(gt['num_stitches']), MAX_STITCHES, None if mask is None else _t(mask))
    theirs = jax_stitches.stitch_precision_recall(
        _j(preds['stitch_tags']), _j(preds['free_edges_mask']),
        _j(gt['stitches'].astype(np.int32)), _j(gt['num_stitches']), MAX_STITCHES,
        None if mask is None else _j(mask))
    for o, t in zip(ours, theirs):
        _close(o, t)
    assert 0 < float(ours[0]) < 1 and 0 < float(ours[1]) < 1
